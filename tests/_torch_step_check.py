"""One port training step held to the JAX reference's step on the CPU in
float32, with the tolerances of ``tests/test_torch_train_step.py`` (see its
docstring): the losses to rtol 1e-4; each gradient leaf to 1e-4 of its
largest reference value (a rounding-noise leaf, below 1e-6 of the model's
largest gradient, to 1e-4 of that largest); the new parameters to rtol
5e-3 and atol 5e-5 (a noise leaf within the most Adam can move it); BN
statistics, SN vectors and the EMA to rtol 1e-5. The reference's gradients
come from its Adam state: with beta1 = 0 the first moment after a step is
that step's gradient. Imported by name by the port's test files."""

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


def assert_step_matches(new, metrics, st, m, before, noise_move, ema_decay=0.999):
    """The port's step (state ``st`` after it, losses ``m``, G's state dict
    ``before`` it) against the reference's (``new``, ``metrics``).
    ``noise_move``: the most Adam moves a parameter in this step."""
    for k, v in metrics.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, err_msg=k)
    noise = {}
    for model, module in (("G", st.G), ("D", st.D)):
        want = jax_grads(new, model)
        got = {n: p.grad for n, p in module.named_parameters()}
        assert set(got) == set(want)
        top, noise[model] = noise_leaves(want)
        for name, ref in want.items():
            scale = top if name in noise[model] else float(ref.abs().max())
            err = float((got[name] - ref).abs().max())
            assert err <= 1e-4 * scale, (name, err, scale)
    for model, got, want in (
            ("G", st.G.state_dict(),
             from_jax_variables({"params": np_tree(new.params_G), **np_tree(new.aux_G)})),
            ("D", st.D.state_dict(),
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
                np.testing.assert_allclose(g, ref.numpy(), rtol=5e-3, atol=5e-5, err_msg=name)
    for name, ref in from_jax_variables(np_tree(new.ema)).items():
        got = st.ema[name].numpy()
        if name in noise["G"]:
            # EMA = decay·old + (1 - decay)·new: the new value's freedom, scaled
            bound = (1 - ema_decay) * noise_move + 1e-7 * np.abs(before[name].numpy()).max()
            assert np.abs(got - ref.numpy()).max() <= bound, name
        else:
            np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
