"""The functions that ``tests/test_torch_parallel.py`` runs inside the ranks
it starts (``parallel.mesh.run_ranks`` pickles them by name, so they live
in a module of their own): each builds its inputs from numpy arrays or a
seed, runs the port on its rank, and returns host values. No JAX here: a
rank imports the port alone."""

import contextlib
import os

import torch

from infinite_texture_gans_torch.config import prepare_parser
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.ops import collectives
from infinite_texture_gans_torch.parallel.mesh import current_axis
from infinite_texture_gans_torch.train import train_step as port_train_step
from infinite_texture_gans_torch.train.train_step import create_train_state, train_step
from infinite_texture_gans_torch.weights import from_jax_variables

TINY_G = dict(z_dim=8, G_ch=8, base_res=4, n_layers_G=4, attention=False, img_ch=3,
              padding_mode="local", outer_padding="replicate")


def tiny_gen(variables, **kw) -> ResidualPatchGenerator:
    """The tests' tiny eval generator (the reference's ``tiny_gen``) on the
    CPU carrying ``variables`` (a JAX-layout numpy tree)."""
    kw = {k: "auto" if (k, v) == ("chw_tail", "on") else v for k, v in kw.items()}
    gen = ResidualPatchGenerator(**{**TINY_G, **kw})
    gen.load_state_dict(from_jax_variables(variables), strict=True)
    return gen.eval()


def _host(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


@contextlib.contextmanager
def _reference_d(st, d_after, out):
    """Right after the step's D update, D's parameters are recorded into
    ``out`` and set to ``d_after`` (the reference's updated D), so that
    the G pass runs on it (``tests/test_torch_train_options.py:
    g_pass_on_reference_d``)."""
    adam = port_train_step._adam_step

    def step(opt):
        adam(opt)
        if opt is st.opt_D:
            with torch.no_grad():
                for n, p in st.D.named_parameters():
                    out[n] = p.detach().clone()
                    p.copy_(torch.from_numpy(d_after[n]))

    port_train_step._adam_step = step
    try:
        yield
    finally:
        port_train_step._adam_step = adam


def mesh_step(flags, init, real, z, d_after=None, plant=False):
    """One data-parallel step of the port from the reference's initial
    variables ``init`` on the global batch (``real`` crops, ``z`` latents):
    the rank's losses, state dicts, gradients, EMA and, with ``d_after``,
    its own D update (``_reference_d``). ``plant`` removes the BatchNorm
    statistics' all-reduce (each rank normalises by its own slice)."""
    args = prepare_parser().parse_args(flags + ["--device", "cpu"])
    st = create_train_state(args, 2, "cpu", seed=0, axis=current_axis())
    st.G.load_state_dict(from_jax_variables({"params": init["params_G"], **init["aux_G"]},
                                            spectral=True), strict=True)
    st.D.load_state_dict(from_jax_variables({"params": init["params_D"], **init["aux_D"]},
                                            spectral=True), strict=True)
    st.ema = from_jax_variables(init["ema"])
    before = _host(st.G.state_dict())
    d_params = {}
    if plant:
        collectives.global_sums = lambda s1, s2, count: (s1, s2, count)
    ctx = _reference_d(st, d_after, d_params) if d_after is not None else contextlib.nullcontext()
    with ctx:
        m = train_step(st, torch.from_numpy(real), torch.from_numpy(z), smooth=True,
                       use_ema=True, loss_type=args.loss)
    return dict(m={k: float(v) for k, v in m.items()}, G=_host(st.G.state_dict()),
                D=_host(st.D.state_dict()), before=before, d_params=d_params, ema=_host(st.ema),
                grads={f"{model}.{n}": p.grad.detach().clone()
                       for model, mod in (("G", st.G), ("D", st.D))
                       for n, p in mod.named_parameters()})


def train_cli(argv, max_device_mb=None):
    """``train(args)`` of the train CLI inside a rank (the rotating window
    forced by a cap of ``max_device_mb``); the losses."""
    from infinite_texture_gans_torch.data import datasets
    from infinite_texture_gans_torch.train.train_loop import train

    if max_device_mb is not None:
        datasets.DeviceMultiImageSampler.MAX_DEVICE_MB = max_device_mb
    _, g, d = train(prepare_parser().parse_args(argv))
    return g, d


def canvases(cases, tmp):
    """Each case's wavefront canvas (``generate_canvas_wavefront``) and,
    where the case names ``slab_rows``, its slab-streamed PNG written under
    ``tmp`` (rank 0); rank 0 returns the canvases."""
    from infinite_texture_gans_torch.parallel.wavefront import (
        generate_canvas_wavefront,
        generate_canvas_wavefront_streamed,
    )

    out = {}
    for name, c in cases.items():
        gen = tiny_gen(c["variables"], **c["kw"])
        maps = None if c["maps"] is None else [torch.from_numpy(m) for m in c["maps"]]
        size = c["size"]
        out[name] = generate_canvas_wavefront(gen, None, *size, z_full=torch.from_numpy(c["z"]),
                                              maps_full=maps)
        if c.get("slab_rows"):
            generate_canvas_wavefront_streamed(gen, None, *size, os.path.join(tmp, f"{name}.png"),
                                               slab_rows=c["slab_rows"],
                                               z_full=torch.from_numpy(c["z"]), maps_full=maps)
    return out


def sharded(variables, z_one, tot, z_images, size):
    """The width-sharded one pass of ``z_one`` over ``tot`` = (tot_h,
    tot_w) patches (rank 0: the canvas), and this rank's image-sharded
    canvases of ``z_images`` at ``size`` (``shard_images``)."""
    from infinite_texture_gans_torch.parallel.sharded import generate_one_pass_sharded, shard_images
    from infinite_texture_gans_torch.sampling.infinite import generate_canvas

    gen = tiny_gen(variables)
    one = generate_one_pass_sharded(gen, torch.from_numpy(z_one), None, *tot)
    mine = generate_canvas(gen, None, *size, num_images=z_images.shape[0] // current_axis().size,
                           z_full=shard_images(torch.from_numpy(z_images)))
    return None if one is None else one.numpy(), mine
