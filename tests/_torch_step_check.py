"""One port training step held to the JAX reference's step on the CPU in
float32, with the tolerances of ``tests/test_torch_train_step.py`` (see its
docstring): the losses to rtol 1e-4; each gradient leaf to 1e-4 of its
largest reference value (a rounding-noise leaf, below 1e-6 of the model's
largest gradient, to 1e-4 of that largest); the new parameters to rtol
5e-3 and atol 5e-5 (a noise leaf within the most Adam can move it); BN
statistics, SN vectors (D's, and G's where it has them) and the EMA to
rtol 1e-5. The reference's gradients come from its Adam state: with beta1
= 0 the first moment after a step is that step's gradient. Imported by
name by the port's test files.

Two options serve steps whose float32 rounding both sides carry and
amplify: where a leaf's gradient is a small difference of large terms (a
bias under WGAN's cancelling means) or passes through train-mode norms (G's
gradient through D's BatchNorms).

- ``exact`` (JAX's same step in float64, from the same state and draws): a
  gradient leaf outside its limit passes when the port's gradient lies
  within 1e-4 of the leaf's largest value of the float64 one, or no further
  from it than twice JAX's own float32 gradient does. Such a leaf whose
  float64 gradient is itself rounding noise (below 1e-6 of the float64
  model's largest: a bias before a train-mode BatchNorm of D) is then held
  as a noise leaf.
- ``element_noise``: an element whose two gradients differ in sign, or
  whose reference gradient lies below 1e-4 of its leaf's largest value, is
  moved by Adam in a direction the rounding decides; its new value and EMA
  are held as a noise leaf's.

``d_params``: D's parameters as the port's last D update left them, where
the caller then gave D the reference's (so that the G pass runs on the
reference's D and its logits, batch statistics and power iteration do not
carry the D update's rounding-decided moves): those are held to the
reference's new parameters in their place.
"""

import jax
import numpy as np

from infinite_texture_gans_torch.weights import from_jax_variables

NOISE = 1e-6  # a gradient below this share of the model's largest is rounding noise


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def jax_grads(new, model):
    """The step's gradients of ``model`` ('G' or 'D') from the reference's
    new state (beta1 = 0), by the port's parameter names."""
    opt = new.opt_G if model == "G" else new.opt_D
    return from_jax_variables({"params": np_tree(opt[0].mu)})


def noise_leaves(grads):
    top = max(float(v.abs().max()) for v in grads.values())
    return top, {k for k, v in grads.items() if float(v.abs().max()) < NOISE * top}


def assert_step_matches(new, metrics, st, m, before, noise_move, ema_decay=0.999, exact=None,
                        element_noise=False, d_params=None):
    """The port's step (state ``st`` after it, losses ``m``, G's state dict
    ``before`` it) against the reference's (``new``, ``metrics``).
    ``noise_move``: the most Adam moves a parameter in this step.
    ``exact``: None, or a callable that returns the reference's float64
    step's new state (called at most once, where a gradient leaf needs
    it). ``element_noise``, ``d_params``: see the module docstring."""
    for k, v in metrics.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, err_msg=k)
    noise, exact_new, small = {}, [], {}
    for model, module in (("G", st.G), ("D", st.D)):
        want = jax_grads(new, model)
        got = {n: p.grad for n, p in module.named_parameters()}
        if element_noise:
            small.update({(model, n): ((g.abs() < 1e-4 * g.abs().max()) | (got[n] * g <= 0)).numpy()
                          for n, g in want.items()})
        assert set(got) == set(want)
        top, noise[model] = noise_leaves(want)
        for name, ref in want.items():
            scale = top if name in noise[model] else float(ref.abs().max())
            err = float((got[name] - ref).abs().max())
            if err <= 1e-4 * scale:
                continue
            assert exact is not None, (name, err, scale)
            if not exact_new:
                exact_new.append(exact())
            want64 = jax_grads(exact_new[0], model)
            ref64 = want64[name].double()
            port64 = float((got[name].double() - ref64).abs().max())
            jax64 = float((ref.double() - ref64).abs().max())
            limit = max(1e-4 * float(ref64.abs().max()), 2 * jax64)
            assert port64 <= limit, (name, err, scale, port64, jax64)
            top64 = max(float(v.abs().max()) for v in want64.values())
            if float(ref64.abs().max()) < NOISE * top64:
                noise[model].add(name)
    for model, got, want in (
            ("G", st.G.state_dict(),
             from_jax_variables({"params": np_tree(new.params_G), **np_tree(new.aux_G)},
                                spectral=True)),
            ("D", {**st.D.state_dict(), **(d_params or {})},
             from_jax_variables({"params": np_tree(new.params_D), **np_tree(new.aux_D)},
                                spectral=True))):
        assert set(got) == set(want)
        for name, ref in want.items():
            g = got[name].numpy()
            if name.rsplit(".", 1)[-1] in ("mean", "var", "u", "v"):  # BN statistics, SN vectors
                np.testing.assert_allclose(g, ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
            elif name in noise[model]:
                assert np.abs(g - ref.numpy()).max() <= noise_move, name
            else:
                s_ = small.get((model, name), np.zeros(g.shape, bool))
                assert np.abs(g - ref.numpy())[s_].max(initial=0) <= noise_move, name
                np.testing.assert_allclose(g[~s_], ref.numpy()[~s_], rtol=5e-3, atol=5e-5,
                                           err_msg=name)
    for name, ref in from_jax_variables(np_tree(new.ema)).items():
        got = st.ema[name].numpy()
        # EMA = decay·old + (1 - decay)·new: the new value's freedom, scaled
        bound = (1 - ema_decay) * noise_move + 1e-7 * np.abs(before[name].numpy()).max()
        if name in noise["G"]:
            assert np.abs(got - ref.numpy()).max() <= bound, name
        else:
            s_ = small.get(("G", name), np.zeros(got.shape, bool))
            assert np.abs(got - ref.numpy())[s_].max(initial=0) <= bound, name
            np.testing.assert_allclose(got[~s_], ref.numpy()[~s_], rtol=1e-5, atol=1e-7,
                                       err_msg=name)
