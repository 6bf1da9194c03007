"""Reference ``.pth`` checkpoints in the PyTorch port: the importer, the
exporter, the loaders and ``sample --export_pth`` against the JAX package's
own (``tests/test_export.py``'s claims without the reference checkout: JAX's
exporter writes the ``.pth`` files from JAX-initialised variables).

Covers BN, SSM and spectral-norm generators with nonzero BN
``num_batches_tracked`` counters and a ``module.``-prefixed state dict, the
PatchGAN with norm None / batch / instance and SN, and the safe load: a
file that needs any global beyond ``argparse.Namespace`` raises and the
global is never unpickled."""

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.models.discriminator import PatchDiscriminator as JaxD
from infinite_texture_gans_tpu.models.generator import ResidualPatchGenerator as JaxG
from infinite_texture_gans_tpu.train import checkpoint as jax_ckpt
from infinite_texture_gans_tpu.utils import torch_export as jax_export
from infinite_texture_gans_tpu.utils import torch_import as jax_import
from infinite_texture_gans_torch import sample
from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.train import checkpoint
from infinite_texture_gans_torch.utils import torch_export, torch_import
from infinite_texture_gans_torch.weights import from_jax_variables, jax_tree
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)


# tests/test_torch_generator.py's tolerance: f32 sums taken in another order
ATOL, RTOL = 2e-4, 1e-4

SMALL = dict(z_dim=16, G_ch=8, base_res=4, n_layers_G=4, attention=True, img_ch=3)
# the model flags of a reference run's Namespace, and some of its device
# flags; it has none of the port's (compute_dtype, fuse_up, chw_tail)
REFERENCE_NS = dict(SMALL, leak_G=0.0, padding_mode="local", outer_padding="replicate",
                    num_patches_height=3, num_patches_width=3, map_dim=2, padding_size=1,
                    conv_reduction=2, gpu_list=[0], num_gpus=1, D_ch=8, n_layers_D=2)
GENERATORS = {"BN": dict(type_norm="BN", SN=False), "SSM": dict(type_norm="SSM", SN=False),
              "SN": dict(type_norm="BN", SN=True)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for path, a in want.items():
        b = got[path]
        if isinstance(a, int):
            assert type(b) is int and b == a, path
            continue
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        a = np.asarray(a)
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))


def _assert_state_dicts_equal(got, want, jax_gamma=False):
    """Keys, dtypes, shapes and values equal. ``jax_gamma``: ``want`` is
    JAX's exporter's, which writes the attention's 0-d ``gamma`` as shape
    (1,) (``np.ascontiguousarray`` of a 0-d array); the port writes the
    reference's 0-d tensor."""
    assert got.keys() == want.keys()
    for k, a in want.items():
        if jax_gamma and k == "attention.gamma":
            assert a.shape == (1,) and got[k].shape == ()
            a = a.reshape(())
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert torch.equal(got[k], a), k


def _maps(seed, n, cfg, gh=3, gw=3):
    rng = np.random.default_rng(seed)
    b = cfg["base_res"]
    return [rng.standard_normal((n, gh * b * 2**i + 4, gw * b * 2**i + 4, 2), dtype=np.float32)
            for i in range(cfg["n_layers_G"])]


def _z(seed, n):
    b = SMALL["base_res"]
    return np.random.default_rng(seed).standard_normal((n, 3 * b + 2, 3 * b + 2, SMALL["z_dim"]),
                                                       dtype=np.float32)


def _jax_generator_variables(kind):
    """A JAX-initialised generator's variables (numpy), running statistics
    moved off their init and the attention gate opened."""
    spec = GENERATORS[kind]
    gen = JaxG(padding_mode="local", map_dim=2, chw_tail="off", **SMALL, **spec)
    z = jnp.asarray(_z(0, 1))
    if spec["type_norm"] == "SSM":
        maps = [jnp.asarray(m) for m in _maps(0, 1, SMALL)]
        v = jax.jit(lambda z, m: gen.init(jax.random.key(0), z, m, train=True))(z, maps)
    else:
        v = jax.jit(lambda z: gen.init(jax.random.key(0), z, train=True))(z)
    tree = jax.tree_util.tree_map(np.asarray, dict(v))
    rng = np.random.default_rng(11)
    for bn in jax.tree_util.tree_leaves(tree["batch_stats"], is_leaf=lambda d: "mean" in d):
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.2 * rng.random(bn["var"].shape)).astype(np.float32)
    tree["params"]["attention"]["attn"]["gamma"] = np.float32(0.3)
    return tree


def _namespace(kind):
    spec = GENERATORS[kind]
    return argparse.Namespace(**REFERENCE_NS, type_norm_G=spec["type_norm"],
                              spec_norm_G=spec["SN"])


def _load_raw(path):
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def pth_files(tmp_path_factory):
    """kind -> a reference-format ``.pth`` written by JAX's exporter, each
    BN counter set to its own nonzero count; 'prefixed' is the BN file with
    every key under ``module.`` (a DataParallel save)."""
    root = tmp_path_factory.mktemp("pth")
    files = {}
    for kind in GENERATORS:
        path = root / f"{kind}.pth"
        jax_export.export_generator_pth(str(path), _jax_generator_variables(kind),
                                        _namespace(kind), epoch=7, gloss=[1.0, 0.5],
                                        dloss=[0.9, 0.8], seed=3)
        raw = _load_raw(path)
        # the reference's gamma is a 0-d parameter (JAX's exporter writes (1,))
        raw["netG_state_dict"]["attention.gamma"] = raw["netG_state_dict"][
            "attention.gamma"].reshape(())
        nbt = [k for k in raw["netG_state_dict"] if k.endswith("num_batches_tracked")]
        assert nbt
        for i, k in enumerate(nbt):
            raw["netG_state_dict"][k] = torch.tensor(1234 + i, dtype=torch.int64)
        torch.save(raw, path)
        files[kind] = path
    raw = _load_raw(files["BN"])
    raw["netG_state_dict"] = {f"module.{k}": v for k, v in raw["netG_state_dict"].items()}
    files["prefixed"] = root / "prefixed.pth"
    torch.save(raw, files["prefixed"])
    return files


CASES = ["BN", "SSM", "SN", "prefixed"]


def _kind(case):
    return "BN" if case == "prefixed" else case


@pytest.mark.parametrize("case", CASES)
def test_imported_tree_matches_jax(pth_files, case):
    """The port's importer builds JAX's tree leaf for leaf: kernels, BN
    statistics, SN vectors (``v`` in the HWIO-flat order) and the
    ``torch_extras`` counters; the loaders return the same metadata."""
    path = str(pth_files[case])
    spec = GENERATORS[_kind(case)]
    kw = dict(n_layers_G=4, type_norm=spec["type_norm"], attention=True)
    got = torch_import.import_generator(
        torch_import.load_torch_checkpoint(path)["netG_state_dict"], **kw)
    want = jax_import.import_generator(
        jax_import.load_torch_checkpoint(path)["netG_state_dict"], **kw)
    _assert_trees_equal(got, want)
    assert "torch_extras" in got and ("spectral" in got) == spec["SN"]
    meta, jmeta = checkpoint.load_checkpoint(path)["meta"], jax_ckpt.load_checkpoint(path)["meta"]
    assert meta == jmeta and meta["epoch"] == 7 and meta["Gloss"] == [1.0, 0.5]


@pytest.mark.parametrize("case", CASES)
def test_pth_generator_matches_jax_forward(pth_files, case):
    """A ``.pth`` whose Namespace has none of the port's flags builds JAX's
    generator (f32, SN off) and gives JAX's loader's forward."""
    path = str(pth_files[case])
    gen, args, variables = checkpoint.load_generator_from_checkpoint(
        path, device="cpu", with_variables=True)
    assert gen.dtype == torch.float32 and not gen.SN and gen.fuse_up == "auto"
    assert args.padding_size == 1 and args.gpu_list == [0]
    jgen, jvariables, _ = jax_ckpt.load_generator_from_checkpoint(path)
    _assert_trees_equal(variables, jvariables)
    z = _z(5, 2)
    ssm = GENERATORS[_kind(case)]["type_norm"] == "SSM"
    maps = _maps(6, 2, SMALL) if ssm else None
    jargs = (jnp.asarray(z),) + (([jnp.asarray(m) for m in maps],) if ssm else ())
    ref, _ = jgen.apply(jvariables, *jargs, train=False)
    with torch.no_grad():
        out, _ = gen(torch.from_numpy(z), [torch.from_numpy(m) for m in maps] if ssm else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert checkpoint.load_netG(path, device="cpu")[1].G_ch == 8


@pytest.mark.parametrize("kind", list(GENERATORS))
def test_exported_generator_state_dict_matches_jax(pth_files, kind):
    """The port's exporter writes JAX's state dict (keys, dtypes, values)
    from the imported tree, which is the file's own: counters and SN
    vectors included."""
    original = _load_raw(pth_files[kind])["netG_state_dict"]
    tree = torch_import.import_generator(original, n_layers_G=4,
                                         type_norm=GENERATORS[kind]["type_norm"])
    got = torch_export.export_generator_state_dict(tree)
    _assert_state_dicts_equal(got, jax_export.export_generator_state_dict(tree), jax_gamma=True)
    _assert_state_dicts_equal(got, original)


def test_jax_exported_file_loads(tmp_path):
    """A ``.pth`` straight from JAX's exporter (gamma of shape (1,)) loads
    in the port and gives the generator of the reference-shaped file."""
    tree = _jax_generator_variables("BN")
    path = str(tmp_path / "jax.pth")
    jax_export.export_generator_pth(path, tree, _namespace("BN"))
    assert _load_raw(path)["netG_state_dict"]["attention.gamma"].shape == (1,)
    gen, _ = checkpoint.load_generator_from_checkpoint(path, device="cpu")
    want = ResidualPatchGenerator(padding_mode="local", **SMALL)
    want.load_state_dict(from_jax_variables(tree), strict=True)
    got = gen.state_dict()
    assert got.keys() == want.state_dict().keys()
    for k, a in want.state_dict().items():
        assert torch.equal(got[k], a), k


@pytest.mark.parametrize("SN,norm", [(False, None), (False, "batch"), (False, "instance"),
                                     (True, None)])
def test_discriminator_state_dict_matches_jax(SN, norm):
    """A JAX PatchGAN's variables (nonzero running statistics) export to
    JAX's reference ``nn.Sequential`` state dict; importing it back gives
    JAX's tree, which loads into the port's discriminator."""
    d = JaxD(base_ch=8, n_layers_D=3, SN=SN, norm_layer=norm)
    v = jax.jit(lambda x: d.init(jax.random.key(2), x, train=True))(jnp.zeros((1, 32, 32, 3)))
    tree = jax.tree_util.tree_map(np.asarray, dict(v))
    if norm == "batch":
        tree["batch_stats"]["norm1"]["mean"] = np.full(16, 0.25, np.float32)
        tree["torch_extras"] = {"norm2": {"num_batches_tracked": 77}}
    got = torch_export.export_patch_discriminator_state_dict(tree, norm_layer=norm)
    _assert_state_dicts_equal(got, jax_export.export_patch_discriminator_state_dict(
        tree, norm_layer=norm))
    if norm == "batch":
        assert int(got["model.6.num_batches_tracked"]) == 77
    back = torch_import.import_patch_discriminator(got, n_layers_D=3, norm_layer=norm)
    _assert_trees_equal(back, jax_import.import_patch_discriminator(got, n_layers_D=3,
                                                                    norm_layer=norm))
    port = PatchDiscriminator(base_ch=8, n_layers_D=3, SN=SN, norm_layer=norm)
    port.load_state_dict(from_jax_variables(back, spectral=True), strict=True)


def _port_ckpt(path):
    """A port training checkpoint: G with SN (its ``spectral`` vectors),
    D with SN and BatchNorm, the metadata."""
    tree = _jax_generator_variables("SN")
    g = ResidualPatchGenerator(padding_mode="local", SN=True, **SMALL)
    g.load_state_dict(from_jax_variables(tree, spectral=True), strict=True)
    d = PatchDiscriminator(base_ch=8, n_layers_D=2, SN=True, norm_layer="batch")
    with torch.no_grad():
        d.norm1.var.fill_(1.5)
    args = {**REFERENCE_NS, "spec_norm_G": True, "spec_norm_D": True, "norm_layer_D": "batch",
            "compute_dtype": "float32", "device": "cpu"}
    checkpoint.save_checkpoint(path, {
        "meta": {"epoch": 2, "args": args, "seed": 9, "Gloss": [0.1, 0.2], "Dloss": [0.3, 0.4]},
        "netG_variables": jax_tree(g.state_dict()), "netD_variables": jax_tree(d.state_dict())})


def test_sample_export_pth_from_ckpt_matches_jax(tmp_path):
    """``sample --export_pth`` on a port ``.ckpt`` writes JAX's exporter's
    state dicts (G's SN buffers, D's with its BatchNorm) and metadata, and
    JAX's loader reads the file back to the checkpoint's own tree."""
    ckpt, out, ref = (str(tmp_path / n) for n in ("run.ckpt", "run.pth", "ref.pth"))
    _port_ckpt(ckpt)
    sample.main(["--model_path", ckpt, "--export_pth", out, "--device", "cpu"])
    jc = jax_ckpt.load_checkpoint(ckpt)
    _, jv, jargs = jax_ckpt.load_generator_from_checkpoint(ckpt, ckpt=jc)
    meta = jc["meta"]
    jax_export.export_generator_pth(ref, jv, jargs, epoch=meta["epoch"], gloss=meta["Gloss"],
                                    dloss=meta["Dloss"], seed=meta["seed"],
                                    d_variables=jc["netD_variables"], d_norm_layer="batch")
    got, want = _load_raw(out), _load_raw(ref)
    assert set(got) == set(want) == {"netG_state_dict", "netD_state_dict", "args", "epoch",
                                     "Gloss", "Dloss", "seed"}
    _assert_state_dicts_equal(got["netG_state_dict"], want["netG_state_dict"], jax_gamma=True)
    _assert_state_dicts_equal(got["netD_state_dict"], want["netD_state_dict"])
    assert "start.conv.weight_v" in got["netG_state_dict"]
    assert "model.3.running_var" in got["netD_state_dict"]
    assert [got[k] for k in ("epoch", "Gloss", "Dloss", "seed")] == [2, [0.1, 0.2], [0.3, 0.4], 9]
    assert got["args"].norm_layer_D == "batch" and got["args"].fuse_up == "auto"
    _, back, _ = jax_ckpt.load_generator_from_checkpoint(out)
    _assert_trees_equal({c: back[c] for c in ("params", "batch_stats", "spectral")},
                        {c: jc["netG_variables"][c] for c in ("params", "batch_stats",
                                                              "spectral")})


def test_sample_export_pth_from_pth_is_identity(pth_files, tmp_path):
    """``.pth -> .pth`` keeps the generator's state dict bit for bit (the
    SN buffers and the BN counters), a ``module.`` prefix dropped; JAX's
    loader reads the re-export."""
    for case in ("SN", "prefixed"):
        out = tmp_path / f"{case}_again.pth"
        sample.main(["--model_path", str(pth_files[case]), "--export_pth", str(out),
                     "--device", "cpu"])
        got, src = _load_raw(out), _load_raw(pth_files[case])
        want = torch_import.strip_module_prefix(src["netG_state_dict"])
        _assert_state_dicts_equal(got["netG_state_dict"], want)
        assert [got[k] for k in ("epoch", "Gloss", "Dloss", "seed")] == [7, [1.0, 0.5],
                                                                      [0.9, 0.8], 3]
        assert vars(got["args"]) == {**vars(src["args"]),
                                     **{k: v for k, v in vars(got["args"]).items()
                                        if k not in vars(src["args"])}}
        _, jv, _ = jax_ckpt.load_generator_from_checkpoint(str(out))
        _, jsrc, _ = jax_ckpt.load_generator_from_checkpoint(str(pth_files[case]))
        _assert_trees_equal(jv, jsrc)


SPRUNG = []


def _spring(tag):
    SPRUNG.append(tag)
    return tag


class _Trap:
    def __reduce__(self):
        return _spring, ("unpickled",)


def test_unsafe_pth_raises_and_is_never_unpickled(pth_files, tmp_path):
    """A file that needs a global beyond ``argparse.Namespace`` raises a
    ``ValueError`` naming it, through the loaders and the sample CLI, and
    the global is never called (no retry without ``weights_only``)."""
    raw = _load_raw(pth_files["BN"])
    raw["extra"] = _Trap()
    path = tmp_path / "trap.pth"
    torch.save(raw, path)
    for load in (lambda: torch_import.load_torch_checkpoint(str(path)),
                 lambda: checkpoint.load_checkpoint(str(path)),
                 lambda: checkpoint.load_generator_from_checkpoint(str(path), device="cpu"),
                 lambda: sample.main(["--model_path", str(path), "--device", "cpu"])):
        with pytest.raises(ValueError, match="_spring"):
            load()
    assert SPRUNG == []
    assert jax_import.load_torch_checkpoint(str(path))["extra"] == "unpickled"  # JAX's would
    assert SPRUNG == ["unpickled"]


def test_port_never_loads_without_weights_only():
    """No port source calls ``torch.load`` with ``weights_only=False``."""
    root = Path(__file__).resolve().parents[1]
    sources = sorted((root / "infinite_texture_gans_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    bad = [str(p.relative_to(root)) for p in sources
           if "weights_only=False" in p.read_text().replace(" ", "")]
    assert not bad, bad
