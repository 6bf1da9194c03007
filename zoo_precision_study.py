#!/usr/bin/env python3
"""How far the discriminator zoo's float32 sits from exact arithmetic on one
card, and which route moves it.

Run from the root of a checkout: ``python3 zoo_precision_study.py``. For
each case of ``chip_smoke.py``'s phase 13 ``[zoo]`` (its weights, its
train-mode forward with an SN refresh and a backward) and each of DRAWS
input draws (``chip_smoke.zoo_inputs``; the phase uses the first
``ZOO_DRAWS``) it runs the model in float32

- on the CPU;
- on the card through cuDNN (TF32 off), as the phase does;
- on the card with cuDNN off (PyTorch's own convolutions, TF32 off);
- on the card through cuDNN with TF32 on (the control the phase's float32
  gate must tell apart);

and prints, for each, the median gradient's deviation from the CPU's
float64 run (``chip_smoke.zoo_errors``: a tensor's largest deviation over
its largest value), each draw's and their median. The per-tensor table
goes to ``build/zoo_precision_study.json``.

Then, for each conv of ``SNDiscriminator`` at the phase's shapes, the
forward, the input gradient and the weight gradient in float32 on the card
(TF32 off) from one set of random operands, with the activations as
channels-last views (the port's NHWC ``Conv``) and as contiguous NCHW
tensors, through cuDNN and with cuDNN off: each result's largest deviation
from the CPU's float64 over that result's largest value.
"""

from __future__ import annotations

import copy
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# run name -> (device, cudnn.enabled, TF32)
RUNS = {
    "cpu": ("cpu", True, False),
    "card cuDNN": ("cuda", True, False),
    "card cuDNN off": ("cuda", False, False),
    "card TF32 (control)": ("cuda", True, True),
}
DRAWS = 10


def conv_table(cs) -> None:
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    ch, res, cin = 64, 64, 3
    g = torch.Generator().manual_seed(2)
    for i, cout in enumerate((ch, ch, ch * 2, ch * 2, ch * 4, ch * 4, ch * 8), start=1):
        k, stride = (3, 1) if i % 2 else (4, 2)
        out_res = res // stride
        x = torch.randn(cs.ZOO_BATCH, cin, res, res, generator=g, dtype=torch.float64)
        w = torch.randn(cout, cin, k, k, generator=g, dtype=torch.float64) / (k * k * cin) ** 0.5
        dy = torch.randn(cs.ZOO_BATCH, cout, out_res, out_res, generator=g, dtype=torch.float64)

        def ops(x, w, dy):
            return {"forward": F.conv2d(x, w, None, stride, 1),
                    "dx": conv2d_input(x.shape, w, dy, stride, 1),
                    "dW": conv2d_weight(x, w.shape, dy, stride, 1)}

        exact = ops(x, w, dy)
        line = []
        for layout in ("channels-last", "NCHW"):
            fmt = torch.channels_last if layout == "channels-last" else torch.contiguous_format
            for enabled in (True, False):
                torch.backends.cudnn.enabled = enabled
                got = ops(*(t.float().cuda().contiguous(memory_format=fmt) for t in (x, w, dy)))
                torch.cuda.synchronize()
                errs = " ".join(
                    f"{n} {float((got[n].double().cpu() - e).abs().max() / e.abs().max()):.1e}"
                    for n, e in exact.items())
                line.append(f"{layout}, cuDNN {'on' if enabled else 'off'}: {errs}")
        torch.backends.cudnn.enabled = True
        print(f"[zoo precision] SNDiscriminator conv{i} ({k}x{k}/{stride}, {cin} -> {cout} at "
              f"{res}^2, batch {cs.ZOO_BATCH}): " + "; ".join(line))
        cin, res = cout, out_res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("zoo_precision_study: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(f"card: {cs.card_line()}")
    table = {}
    for label, (cls, kw) in cs.ZOO_CASES.items():
        models = cs.zoo_models(cls, kw)
        medians = {run: [] for run in RUNS}
        table[label] = []
        for draw in range(DRAWS):
            x, y = cs.zoo_inputs(kw, draw)
            exact = cs.zoo_run(copy.deepcopy(models[torch.float64]), x, y, torch.device("cpu"))
            errs = {}
            for run, (dev, enabled, tf32) in RUNS.items():
                torch.backends.cudnn.enabled = enabled
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
                model = copy.deepcopy(models[torch.float32]).to(dev)
                errs[run] = cs.zoo_errors(cs.zoo_run(model, x, y, torch.device(dev)), exact)
                medians[run].append(statistics.median(
                    v for k, v in errs[run].items() if k.startswith("d ")))
            torch.backends.cudnn.enabled = True
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            table[label].append(errs)
        print(f"[zoo precision] {label}: float32 gradients' median against the CPU's float64, "
              f"median over {DRAWS} input draws (each draw's)")
        for run, v in medians.items():
            print(f"  {run}: {statistics.median(v):.2e} ("
                  + " ".join(f"{e:.1e}" for e in v) + ")")
    conv_table(cs)
    out = ROOT / "build" / "zoo_precision_study.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(table, indent=1))
    print(f"per-tensor table: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
