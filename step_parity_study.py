#!/usr/bin/env python3
"""Step parity's spread, and its power to catch a wrong kernel, on one card.

Run from the root of a checkout: ``python3 step_parity_study.py [RECIPE
...]`` (all recipes by default). For the SSM recipe, the Experiment-1 step
under ``--fuse_up off`` and the WGAN-GP recipe of ``chip_smoke.py``'s phase
10 (``--fuse_up auto --loss wgan --gp_weight 10 --disc_iters 5``; full
width, float32 with TF32 off; ``chip_smoke.py``'s flags, inputs and state)
it runs one train step

- with the kernels, twice (the atomics' order varies);
- with the kernels' plain versions (step parity's comparison run);
- in float64 on the CPU with every block NHWC (the exact reference);
- with a planted fault: K6 drops the replicate fold of the top border from
  its dx (interior columns, every call); for SSM also the embed backward's
  dW1 scaled by 1 + 1e-2 and by 1 + 3e-3;

and prints, for pairs of these runs, each model's largest per-leaf
deviation as step parity measures it (max |diff| over the leaf's largest
value) and the largest norm-relative one, with their leaves, and whether
``chip_smoke.py``'s limits for the recipe pass the pair. The per-leaf table goes to
``build/step_parity_study.json``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


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


def scale_dw1(factor):
    def wrap(bwd):
        def faulty(maps, w1, b1, w2, g):
            dw2, db2, dw1, db1 = bwd(maps, w1, b1, w2, g)
            return dw2, db2, dw1 * factor, db1

        return faulty

    return wrap


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
    unknown = set(sys.argv[1:]) - set(recipes)
    if unknown:
        print(f"step_parity_study: no recipe {sorted(unknown)}; recipes {sorted(recipes)}",
              file=sys.stderr)
        return 2
    recipes = {k: v for k, v in recipes.items() if not sys.argv[1:] or k in sys.argv[1:]}
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
        for name, kw in (("kernels", {}), ("kernels again", {}),
                         ("plain", dict(patch=cs.plain_tail)), ("float64", dict(reference=True)),
                         *((f, dict(patch=p)) for f, p in faults.items())):
            t0 = time.perf_counter()
            runs[name] = cs.run_step(dev, args, real, draws, sync, **kw)
            print(f"[{recipe}] {name}: losses {runs[name][0]} ({time.perf_counter() - t0:.1f} s)")
        pairs = [("kernels again", "kernels"), ("kernels", "plain"), ("plain", "float64"),
                 ("kernels", "float64")]
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
        table["recipes"][recipe] = rows
        del runs
    out = ROOT / "build" / "step_parity_study.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(table, indent=1))
    print(f"wrote {out.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
