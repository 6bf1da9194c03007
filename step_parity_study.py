#!/usr/bin/env python3
"""Step parity's spread, and its power to catch a wrong kernel, on one card.

Run from the root of a checkout: ``python3 step_parity_study.py [RECIPE
...]`` (all recipes by default). For the SSM recipe, the Experiment-1 step
under ``--fuse_up off`` and the WGAN-GP recipe of ``chip_smoke.py``'s phase
10 (``--fuse_up auto --loss wgan --gp_weight 10 --disc_iters 5``; full
width, float32 with TF32 off; ``chip_smoke.py``'s flags, inputs and state)
it runs one train step

- with the kernels, twice (the atomics' order varies);
- with the kernels' plain versions (step parity's comparison run), twice;
- the same four runs with cuDNN off (``torch.backends.cudnn.enabled =
  False`` for the run: PyTorch's own CUDA convolutions in its place);
- in float64 on the CPU with every block NHWC (the exact reference);
- in float32 on the CPU with every block NHWC (the recipe's own rounding,
  amplified as the step amplifies it);
- with a planted fault: K6 drops the replicate fold of the top border from
  its dx (interior columns, every call); for SSM also the embed backward's
  dW1 scaled by 1 + 1e-2 and by 1 + 3e-3;

and prints, for pairs of these runs, each model's largest per-leaf
deviation as step parity measures it (max |diff| over the leaf's largest
value) and the largest norm-relative one, with their leaves, and whether
``chip_smoke.py``'s limits for the recipe pass the pair. Each recipe ends
with the float32 verdict: the card's float32 steps, cuDNN on and off, over
the CPU's float32 step, each model's largest per-leaf deviation from float64
(the card's spread over its two runs), and whether cuDNN off sits within
``AMPLIFIED`` of the CPU. The per-leaf table goes to
``build/step_parity_study.json``.

``python3 step_parity_study.py --forward [RECIPE ...]`` compares the step's
forward instead: every output of G's blocks (the last D iteration's G pass,
the one the G update differentiates) and of D's convolutions after the stem
(every D pass of the step), each as its largest deviation from the float64
step's over that tensor's largest value, for the CPU's float32 step and the
card's (kernels with cuDNN on; kernels and plain versions with cuDNN off),
in the order the step computes them (the stem's output as D's ``conv1``
takes it too); then the losses, and both models' parameters after the step,
over every element and over those whose float64 gradient is at least
``FIRM`` of the leaf's largest. It names the first tensor where the card
with cuDNN off sits more than ``STRAYED`` times further out than the CPU's
float32 step, and writes ``build/step_parity_forward.json``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's float32 step with cuDNN off is the recipe's own rounding when it
# sits within this factor of the CPU's float32 step (both against float64)
AMPLIFIED = 2.0
# a tensor of the forward where the card strays this many times further from
# float64 than the CPU's float32 step does is an op to repair
STRAYED = 10.0
# an element whose float64 gradient is at least this share of its leaf's
# largest: Adam's first step (lr * g / (|g| + eps), beta1 0) is lr * sign(g)
# there, blind to the gradient's rounding
FIRM = 1e-3


@contextlib.contextmanager
def patched(mod, name, wrap):
    """``mod.name`` replaced by ``wrap(mod.name)`` for the block."""
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def drop_top_fold(k6):
    """K6 whose dx lacks the replicate fold of the top border: its first
    row's interior columns taken from the zero-padded dx, which differs from
    the replicate one there by exactly that fold."""

    def faulty(x, g, w, scale, shift, relu, outer_padding):
        dx, dsc, dsh = k6(x, g, w, scale, shift, relu, outer_padding)
        if outer_padding == "replicate":
            dx0 = k6(x, g, w, scale, shift, relu, "constant")[0]
            dx = dx.clone()
            dx[..., 0, 1:-1] = dx0[..., 0, 1:-1]
        return dx, dsc, dsh

    return faulty


@contextlib.contextmanager
def cudnn_off():
    import torch

    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = True


@contextlib.contextmanager
def plain_cudnn_off():
    import chip_smoke as cs

    with cs.plain_tail(), cudnn_off():
        yield


def scale_dw1(factor):
    def wrap(bwd):
        def faulty(maps, w1, b1, w2, g):
            dw2, db2, dw1, db1 = bwd(maps, w1, b1, w2, g)
            return dw2, db2, dw1 * factor, db1

        return faulty

    return wrap


class ForwardTap:
    """Forward hooks on the G and D of every train state made while it is
    entered (``create_train_state`` wrapped): G's ``start``, blocks and
    attention and G itself, on the G pass with gradients; D's convolutions
    after the stem and the stem's activated output (the card's stem is a
    kernel on channels-major fakes, the CPU's ``conv0``), on every pass.
    With no ``ref``, each output is kept (float64, on the CPU); with
    ``ref``, its deviation from the kept one."""

    def __init__(self, ref=None):
        self.ref, self.out, self.calls = ref, {}, {}

    def _record(self, name, output):
        import torch

        if name.startswith("G") and not torch.is_grad_enabled():
            return
        n = self.calls[name] = self.calls.get(name, -1) + 1
        t = (output[0] if isinstance(output, tuple) else output).detach()
        t = t.to("cpu", torch.float64)
        if self.ref is None:
            self.out[(name, n)] = t
            return
        want = self.ref[(name, n)]
        if t.shape != want.shape:  # a channels-major tail against NHWC
            t = t.permute(0, 2, 3, 1) if t.permute(0, 2, 3, 1).shape == want.shape \
                else t.permute(0, 3, 1, 2)
        self.out[(name, n)] = float((t - want).abs().max()) / float(want.abs().max())

    def updated(self):
        """Both models' parameters as the step left them (float64, CPU)."""
        import torch

        return {f"{m}.{n}": p.detach().to("cpu", torch.float64)
                for m, mod in (("G", self.state.G), ("D", self.state.D))
                for n, p in mod.named_parameters()}

    def _tap(self, name, module):
        if name == "D.conv1":  # its input: the stem's output, after the activation
            module.register_forward_hook(lambda m, i, out: self._record("D.stem", i[0]))
        if hasattr(module, "forward_train"):  # G's blocks: the train pass's own entry
            fwd = module.forward_train

            def forward_train(*a, **kw):
                out = fwd(*a, **kw)
                self._record(name, out)
                return out

            module.forward_train = forward_train
        else:
            module.register_forward_hook(lambda m, i, out: self._record(name, out))

    @contextlib.contextmanager
    def __call__(self):
        from infinite_texture_gans_torch.train import train_step as step_mod

        def tapped(make):
            def create(*a, **kw):
                st = self.state = make(*a, **kw)
                mods = [("G", st.G)] + [(f"G.{n}", m) for n, m in st.G.named_children()
                                        if n == "start" or n.startswith("block")
                                        or n == "attention"]
                mods += [(f"D.{n}", m) for n, m in st.D.named_children()
                         if n.startswith("conv") and n != "conv0"]
                for name, m in mods:
                    self._tap(name, m)
                return st

            return create

        with patched(step_mod, "create_train_state", tapped):
            yield


def forward_bisect(recipe, dev, args, real, draws, sync, card):
    """The step's forward, tensor by tensor: (a) the CPU's float32, (b) the
    card's kernels with cuDNN on, (c) with cuDNN off (kernels and plain
    versions), each against the CPU's float64."""
    import torch

    import chip_smoke as cs

    ref = ForwardTap()
    with ref():
        want, grads_g, grads_d, _ = cs.run_step(dev, args, real, draws, sync,
                                                reference=torch.float64)
    ref_params = ref.updated()
    # a leaf whose float64 gradient is rounding noise (a bias before a
    # train-mode BatchNorm: zero in exact arithmetic, and no output sees it)
    # is left out of the largest: Adam's first step makes noise of any size
    noise = set()
    for grads in (grads_g, grads_d):
        top = max(float(g.abs().max()) for g in grads.values())
        noise |= {k for k, g in grads.items() if float(g.abs().max()) < cs.NOISE_SHARE * top}
    scale = {k: max(float(v.abs().max()), 1e-30) for k, v in ref_params.items()}
    firm = {k: (g.abs() >= FIRM * g.abs().max()).cpu()
            for k, g in {**grads_g, **grads_d}.items()}
    runs = {"a float32 CPU": dict(reference=torch.float32), "b kernels": {},
            "c kernels cuDNN off": dict(patch=cudnn_off),
            "c plain cuDNN off": dict(patch=plain_cudnn_off)}
    shares, losses, params, firm_params = {}, {}, {}, {}
    for label, kw in runs.items():
        tap = ForwardTap(ref.out)
        with tap():
            got = cs.run_step(dev, args, real, draws, sync, **kw)[0]
        shares[label] = tap.out
        diffs = {k: (v - ref_params[k]).abs() for k, v in tap.updated().items()}
        params[label] = {k: float(d.max()) / scale[k] for k, d in diffs.items()}
        firm_params[label] = {k: float(d[firm[k]].max()) / scale[k] for k, d in diffs.items()
                              if firm[k].any()}
        losses[label] = max(abs(got[k] - v) / max(abs(v), 1e-30) for k, v in want.items())
    del ref
    order = list(shares["a float32 CPU"])  # the order the step computed them
    first, rows = None, []
    for key in order:
        a = shares["a float32 CPU"][key]
        c = max(shares["c kernels cuDNN off"][key], shares["c plain cuDNN off"][key])
        ratio = c / max(a, 1e-30)
        rows.append({"tensor": f"{key[0]} #{key[1]}", "a": a, "b": shares["b kernels"][key],
                     "c": c, "c_over_a": ratio})
        if first is None and ratio > STRAYED:
            first = rows[-1]["tensor"]
        print(f"[{recipe} forward] {key[0]} #{key[1]}: (a) {a:.3e} (b) "
              f"{shares['b kernels'][key]:.3e} (c) {c:.3e}; (c) / (a) {ratio:.2f}")
    for label, v in losses.items():
        print(f"[{recipe} forward] losses, {label}: {v:.3e} relative to float64")
    updated = {}
    for model in ("G", "D"):
        leaves = [k for k in ref_params if k.startswith(model + ".")]
        for label, p in params.items():
            top = max((k for k in leaves if k not in noise), key=lambda k: p[k])
            f = firm_params[label]
            top_f = max((k for k in leaves if k not in noise and k in f), key=lambda k: f[k])
            print(f"[{recipe} forward] {model}'s parameters after the step, {label}: largest "
                  f"{p[top]:.3e} of the leaf's largest value ({top}; (a) there "
                  f"{params['a float32 CPU'][top]:.3e}; {len(noise & set(leaves))} leaves of "
                  f"rounding-noise gradients left out); where |g| >= {FIRM:g} of the leaf's "
                  f"largest gradient {f[top_f]:.3e} ({top_f}; (a) there "
                  f"{firm_params['a float32 CPU'][top_f]:.3e})")
        updated[model] = {k: {label: p[k] for label, p in params.items()} for k in leaves}
        updated[model + " firm"] = {k: {label: f[k] for label, f in firm_params.items()}
                                    for k in leaves if k in firm_params[label]}
    worst = max(rows, key=lambda r: r["c_over_a"])
    print(f"[{recipe} forward] {len(rows)} tensors; largest (c) / (a) {worst['c_over_a']:.2f} at "
          f"{worst['tensor']}; first beyond {STRAYED:g}x: {first or 'none'} [{card}]")
    return {"tensors": rows, "losses": losses, "updated": updated, "first_strayed": first}


def float32_verdict(recipe, rows, card_runs, card):
    """Each model's largest deviation from float64: (a) the CPU's float32
    step, (b) the card's with cuDNN on, (c) with cuDNN off (the largest and
    smallest over each side's four runs, kernels and plain versions), and
    (c) over (a) at the largest leaves."""
    out = {}
    for model in ("G", "D"):
        cpu = rows["float32 CPU vs float64"][model]
        a_leaves = cpu["leaves"]
        out[model] = {"a": [cpu["share"], cpu["worst"]]}
        for side, label in (("on", "b"), ("off", "c")):
            shares = {r: rows[f"{r} vs float64"][model] for r in card_runs[side]}
            worst = max(shares, key=lambda r: shares[r]["share"])
            lo = min(v["share"] for v in shares.values())
            out[model][label] = [shares[worst]["share"], shares[worst]["worst"], lo]
            leaf = shares[worst]["worst"]
            print(f"[{recipe}] float32 {model}: ({label}) card, cuDNN {side}, "
                  f"{lo:.3e}-{shares[worst]['share']:.3e} of the leaf's largest value over "
                  f"{len(shares)} runs ({leaf}; the CPU's float32 there "
                  f"{a_leaves[leaf][0]:.3e})")
        print(f"[{recipe}] float32 {model}: (a) CPU float32 {cpu['share']:.3e} ({cpu['worst']})")
        ratio = out[model]["c"][0] / max(cpu["share"], 1e-30)
        out[model]["c_over_a"] = ratio
        print(f"[{recipe}] float32 {model}: (c) / (a) = {ratio:.2f}: "
              f"{'within' if ratio <= AMPLIFIED else 'OUTSIDE'} {AMPLIFIED:g}x [{card}]")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_parity_study: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from infinite_texture_gans_torch.ops import _build, kernels, ssm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, {torch.get_num_threads()} CPU threads")
    _build.library()
    dev = torch.device("cuda")

    def sync():
        torch.cuda.synchronize()

    k6_fault = lambda: patched(kernels, "conv3x3_chw_dx", drop_top_fold)  # noqa: E731
    recipes = {
        "SSM": (cs.SSM_ARGS + ["--compute_dtype", "float32"],
                {"K6 top fold dropped": k6_fault,
                 "dW1 x (1 + 1e-2)": lambda: patched(ssm, "ssm_embed_bwd", scale_dw1(1 + 1e-2)),
                 "dW1 x (1 + 3e-3)": lambda: patched(ssm, "ssm_embed_bwd", scale_dw1(1 + 3e-3))}),
        "BN off": (cs.EXP1_ARGS + ["--compute_dtype", "float32", "--fuse_up", "off"],
                   {"K6 top fold dropped": k6_fault}),
        "WGAN": (cs.EXP1_ARGS + ["--compute_dtype", "float32", "--fuse_up", "auto"]
                 + cs.OPTION_RECIPES["wgan"], {"K6 top fold dropped": k6_fault}),
    }
    argv = sys.argv[1:]
    forward = "--forward" in argv
    argv = [a for a in argv if a != "--forward"]
    unknown = set(argv) - set(recipes)
    if unknown:
        print(f"step_parity_study: no recipe {sorted(unknown)}; recipes {sorted(recipes)}",
              file=sys.stderr)
        return 2
    recipes = {k: v for k, v in recipes.items() if not argv or k in argv}
    if forward:
        table = {"card": card, "strayed": STRAYED, "recipes": {}}
        for recipe, (flags, _) in recipes.items():
            args, real, draws = cs.parity_inputs(dev, flags)
            table["recipes"][recipe] = forward_bisect(recipe, dev, args, real, draws, sync, card)
        out = ROOT / "build" / "step_parity_forward.json"
        out.parent.mkdir(exist_ok=True)
        out.write_text(json.dumps(table, indent=1))
        print(f"wrote {out.relative_to(ROOT)}")
        return 0
    # chip_smoke's gates by recipe: (losses, a leaf's largest deviation)
    limits = {r: (cs.STEP_LOSS_TOL, cs.STEP_GRAD_TOL) for r in recipes}
    if "WGAN" in limits:
        limits["WGAN"] = (cs.WGAN_STEP_LOSS_TOL, cs.WGAN_STEP_GRAD_TOL)
    table = {"card": card, "limits": {r: {"loss": lo, "grad": gr, "noise": cs.NOISE_TOL}
                                      for r, (lo, gr) in limits.items()}, "recipes": {}}
    for recipe, (argv, faults) in recipes.items():
        loss_tol, grad_tol = limits[recipe]
        args, real, draws = cs.parity_inputs(dev, argv)
        runs = {}
        card_runs = {"on": ("kernels", "kernels again", "plain", "plain again"),
                     "off": ("kernels cuDNN off", "kernels cuDNN off again",
                             "plain cuDNN off", "plain cuDNN off again")}
        for name, kw in (("kernels", {}), ("kernels again", {}),
                         ("plain", dict(patch=cs.plain_tail)),
                         ("plain again", dict(patch=cs.plain_tail)),
                         ("kernels cuDNN off", dict(patch=cudnn_off)),
                         ("kernels cuDNN off again", dict(patch=cudnn_off)),
                         ("plain cuDNN off", dict(patch=plain_cudnn_off)),
                         ("plain cuDNN off again", dict(patch=plain_cudnn_off)),
                         ("float64", dict(reference=torch.float64)),
                         ("float32 CPU", dict(reference=torch.float32)),
                         *((f, dict(patch=p)) for f, p in faults.items())):
            t0 = time.perf_counter()
            runs[name] = cs.run_step(dev, args, real, draws, sync, **kw)
            print(f"[{recipe}] {name}: losses {runs[name][0]} ({time.perf_counter() - t0:.1f} s)")
        pairs = [("kernels again", "kernels"), ("kernels", "plain"),
                 *((r, "float64") for r in card_runs["on"] + card_runs["off"]),
                 ("float32 CPU", "float64"), ("kernels cuDNN off", "plain cuDNN off")]
        pairs += [(f, ref) for f in faults for ref in ("plain", "float64")]
        rows = {}
        for got, want in pairs:
            (lg, gg, dg, _), (lw, gw, dw, _) = runs[got], runs[want]
            loss = max(abs(lg[k] - v) / max(abs(v), 1e-30) for k, v in lw.items())
            row = {"loss_rel": loss, "passes": loss <= loss_tol}
            for model, a, b in (("G", gg, gw), ("D", dg, dw)):
                devs = cs.leaf_deviations(a, b)
                signal = {k: v for k, v in devs.items() if not v[2]}
                noise = [v[0] for v in devs.values() if v[2]]
                worst = max(signal, key=lambda k: signal[k][0])
                worst_n = max(signal, key=lambda k: signal[k][1])
                ok = all(v[0] <= (cs.NOISE_TOL if v[2] else grad_tol) for v in devs.values())
                row["passes"] = row["passes"] and ok
                row[model] = {"worst": worst, "share": signal[worst][0], "worst_norm": worst_n,
                              "norm_rel": signal[worst_n][1], "noise_share": max(noise, default=0.0),
                              "leaves": {k: v[:2] for k, v in devs.items()}}
                top5 = sorted(signal, key=lambda k: -signal[k][0])[:5]
                print(f"[{recipe}] {got} vs {want}, {model}: largest {signal[worst][0]:.3e} of the "
                      f"leaf's largest value ({worst}); norm-relative {signal[worst_n][1]:.3e} "
                      f"({worst_n}); noise leaves {max(noise, default=0.0):.3e} of the largest; "
                      f"next: {', '.join(f'{k} {signal[k][0]:.2e}' for k in top5[1:])}")
            print(f"[{recipe}] {got} vs {want}: losses {loss:.3e}; chip_smoke's limits "
                  f"{'pass' if row['passes'] else 'FAIL'} it [{card}]")
            rows[f"{got} vs {want}"] = row
        rows["float32 verdict"] = float32_verdict(recipe, rows, card_runs, card)
        table["recipes"][recipe] = rows
        del runs
    out = ROOT / "build" / "step_parity_study.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(table, indent=1))
    print(f"wrote {out.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
