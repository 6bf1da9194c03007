"""The PyTorch port's quality metrics against the JAX package's: the stored
default pyramid bit for bit against JAX's draw, the features and every
metric on the same images, ``tests/test_quality.py``'s claims (a
reduced-width AlexNet stub for the pretrained path), the safe weights load
and the CLI.

The stored pyramid is written by :func:`write_pyramid` (JAX, CPU):
``JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests'];
import test_torch_quality as t; t.write_pyramid()"`` from the repository's
root."""

import json

import jax
import numpy as np
import pytest
import torch

from infinite_texture_gans_tpu.utils import quality as jq
from infinite_texture_gans_torch.utils import quality as Q
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

REL = 1e-5


def jax_pyramid():
    """The kernels of JAX's default ``random_conv_features()`` (key 1234,
    depths 16/32/64, 5x5), drawn as it draws them."""
    keys = jax.random.split(jax.random.key(1234), 3)
    out, cin = [], 3
    for k, cout in zip(keys, (16, 32, 64)):
        w = jax.random.normal(k, (5, 5, cin, cout)) / np.sqrt(5 * 5 * cin)
        out.append(np.asarray(w))
        cin = cout
    return out


def write_pyramid(path=Q.PYRAMID_FILE):
    np.savez(path, **{f"w{i}": w for i, w in enumerate(jax_pyramid())})


def _smooth(x, k=4):
    """A box blur through cumulative sums."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((k, 0), (k, 0), (0, 0)))
    out = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return (out / (k * k)).astype(np.float32)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    tex = _smooth(rng.uniform(-1, 1, (96, 96, 3)))
    similar = _smooth(rng.uniform(-1, 1, (96, 96, 3)))
    different = np.sign(rng.uniform(-1, 1, (96, 96, 3))).astype(np.float32)
    other = _smooth(rng.uniform(-1, 1, (80, 112, 3)))
    return tex, similar, different, other


def test_stored_pyramid_is_jax_draw():
    stored = Q.stored_pyramid()
    want = jax_pyramid()
    assert len(stored) == 3
    for got, w in zip(stored, want):
        assert got.dtype == np.float32 and got.shape == w.shape
        np.testing.assert_array_equal(got.view(np.uint32), w.view(np.uint32))


def test_default_features_match_jax(images):
    tex, _, _, other = images
    for img in (tex, other):
        got = Q.random_conv_features("cpu")(img[None])
        want = jq.random_conv_features()(img[None])
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=REL, atol=REL * np.abs(w).max())


def test_metrics_match_jax_on_default_pyramid(images):
    """SIFID, LPIPS, Gram and the report within 1e-5 relative of JAX's."""
    tex, similar, different, other = images
    pf, jf = Q.random_conv_features("cpu"), jq.random_conv_features()
    for b in (similar, different):
        assert Q.sifid(tex, b, pf) == pytest.approx(jq.sifid(tex, b, jf), rel=REL)
        assert Q.lpips_distance(tex, b, pf) == pytest.approx(jq.lpips_distance(tex, b, jf),
                                                              rel=REL)
        assert Q.gram_distance(tex, b, pf) == pytest.approx(jq.gram_distance(tex, b, jf),
                                                             rel=REL)
    got = Q.texture_quality_report(tex, other, pf)
    want = jq.texture_quality_report(tex, other, jf)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL), k


def test_extractors_default_to_the_card(images, monkeypatch):
    """Without ``device`` (or a ``features_fn``) every extractor and metric
    runs on the card: its features lie there, and without a card each call
    raises, with no silent CPU fallback."""
    monkeypatch.setattr(Q, "_resolve_cache", {})
    monkeypatch.setattr(Q, "_default_cache", {})
    monkeypatch.delenv(Q.WEIGHTS_ENV, raising=False)
    tex, similar = images[:2]
    extractors = [Q.random_conv_features, Q.resolve_features_fn,
                  lambda: Q.alexnet_features_from_state_dict(_stub_alexnet_state_dict())]
    metrics = [lambda: Q.sifid(tex, similar), lambda: Q.lpips_distance(tex, similar),
               lambda: Q.gram_distance(tex, similar), lambda: Q.texture_quality_report(tex, similar)]
    if torch.cuda.is_available():
        for make in extractors:
            assert all(f.device.type == "cuda" for f in make()(tex[None]))
        for call in metrics:
            call()
        return
    for call in extractors + metrics:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert Q._default_cache == {} and Q._resolve_cache == {}


def test_frechet_identity_and_shift():
    mu, cov = np.zeros(4), np.eye(4)
    assert Q.frechet_distance(mu, cov, mu, cov) == pytest.approx(0.0, abs=1e-8)
    assert Q.frechet_distance(mu, cov, mu + 2.0, cov) == pytest.approx(16.0, abs=1e-6)


def test_sifid_and_lpips_discriminate(images):
    tex, similar, different, _ = images
    feats = Q.random_conv_features("cpu")
    s_sim, s_diff = Q.sifid(tex, similar, feats), Q.sifid(tex, different, feats)
    assert s_sim >= 0 and s_diff > s_sim
    assert Q.lpips_distance(tex, tex, feats) == pytest.approx(0.0, abs=1e-6)
    mild, heavy = _smooth(tex, 2), np.flip(tex, axis=0).copy()
    assert 0 < Q.lpips_distance(tex, mild, feats) < Q.lpips_distance(tex, heavy, feats)
    assert Q.gram_distance(tex, different, feats) > Q.gram_distance(tex, similar, feats)
    assert Q.spectrum_distance(tex, similar) < Q.spectrum_distance(tex, different)
    assert Q.color_histogram_distance(tex, similar) < Q.color_histogram_distance(tex, different)


def test_report_size_agnostic():
    rng = np.random.default_rng(1)
    src = _smooth(rng.uniform(-1, 1, (80, 64, 3)))
    gen = _smooth(rng.uniform(-1, 1, (128, 160, 3)))
    rep = Q.texture_quality_report(src, gen, Q.resolve_features_fn(device="cpu"))
    assert set(rep) == {"sifid_rand", "gram_dist", "spectrum_dist", "color_hist_chi2"}
    assert all(np.isfinite(v) for v in rep.values())


def test_frechet_distance_known_gaussians():
    """FID(N(0, I), N(0, 4I)) in 3-d is 3 + 12 - 12 = 3; equal covariances
    leave |m1 - m2|^2."""
    mu = np.zeros(3)
    assert Q.frechet_distance(mu, np.eye(3), mu, 4 * np.eye(3)) == pytest.approx(3.0, abs=1e-9)
    assert Q.frechet_distance(np.array([1.0, 2.0, 3.0]), np.eye(3), mu,
                              np.eye(3)) == pytest.approx(14.0, abs=1e-9)


def test_sifid_pluggable_extractor_exact():
    """With an identity extractor SIFID is a closed-form Frechet distance."""
    identity = lambda img: [img]  # noqa: E731
    h = w = 16
    a, b, s = 0.3, -0.1, 0.25
    real = np.full((h, w, 3), a, np.float32)
    fake = np.full((h, w, 3), b, np.float32)
    fake[: h // 2] += s
    fake[h // 2:] -= s
    n = h * w
    expect = 3 * (a - b) ** 2 + 3 * n * s**2 / (n - 1)
    assert Q.sifid(real, fake, features_fn=identity, level=0) == pytest.approx(expect, rel=1e-5)
    assert Q.sifid(fake, fake, features_fn=identity, level=0) == pytest.approx(0.0, abs=1e-7)


def _stub_alexnet_state_dict(width=4):
    """A torchvision-AlexNet-shaped state dict at reduced width."""
    rng = np.random.default_rng(7)
    chans = [3, width, 3 * width, 6 * width, 4 * width, 4 * width]
    sd = {}
    for (idx, _, _), k, cin, cout in zip(Q._ALEXNET_CONVS, [11, 5, 3, 3, 3], chans[:-1],
                                         chans[1:]):
        sd[f"features.{idx}.weight"] = torch.tensor(
            rng.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.1)
        sd[f"features.{idx}.bias"] = torch.tensor(
            rng.standard_normal(cout).astype(np.float32) * 0.01)
    return sd


def test_alexnet_features_from_state_dict(images):
    """The pretrained path's five taps in torch's geometry, equal to JAX's
    on the same stub; SIFID and LPIPS take it."""
    sd = _stub_alexnet_state_dict()
    fn = Q.alexnet_features_from_state_dict(sd, device="cpu")
    feats = fn(np.zeros((1, 96, 96, 3), np.float32))
    assert len(feats) == 5
    assert [tuple(f.shape[1:3]) for f in feats] == [(23, 23), (11, 11), (5, 5), (5, 5), (5, 5)]
    tex = images[0]
    jfn = jq.alexnet_features_from_state_dict({k: v.numpy() for k, v in sd.items()})
    for g, w in zip(fn(tex[None]), jfn(tex[None])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=REL, atol=REL * np.abs(w).max())
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    assert Q.sifid(a, b, features_fn=fn, level=1) >= 0
    assert Q.lpips_distance(a, a, features_fn=fn) == pytest.approx(0.0, abs=1e-9)
    assert Q.lpips_distance(a, b, features_fn=fn) > 0


SPRUNG = []


def _spring(tag):
    SPRUNG.append(tag)
    return tag


class _Trap:
    def __reduce__(self):
        return _spring, ("unpickled",)


def test_resolve_features_fn_autodetect(tmp_path, monkeypatch, capsys):
    """The env var's AlexNet file -> its taps; a missing file, or one that
    needs unpickling, -> the notice and the random pyramid, and the file's
    object is never built (no retry without ``weights_only``); no weights ->
    the random pyramid with its notice."""
    monkeypatch.setattr(Q, "_resolve_cache", {})
    path = str(tmp_path / "alex.pth")
    torch.save(_stub_alexnet_state_dict(), path)
    monkeypatch.setenv(Q.WEIGHTS_ENV, path)
    fn = Q.resolve_features_fn(device="cpu")
    assert len(fn(np.zeros((1, 64, 64, 3), np.float32))) == 5
    assert "pretrained AlexNet" in capsys.readouterr().out

    unsafe = str(tmp_path / "unsafe.pth")
    torch.save({"state_dict": _stub_alexnet_state_dict(), "extra": _Trap()}, unsafe)
    for bad in (str(tmp_path / "missing.pth"), unsafe):
        monkeypatch.setattr(Q, "_resolve_cache", {})
        monkeypatch.setenv(Q.WEIGHTS_ENV, bad)
        fn_bad = Q.resolve_features_fn(device="cpu")
        assert "falling back" in capsys.readouterr().err
        assert len(fn_bad(np.zeros((1, 64, 64, 3), np.float32))) == 3
    assert SPRUNG == []

    monkeypatch.setattr(Q, "_resolve_cache", {})
    monkeypatch.delenv(Q.WEIGHTS_ENV)
    fn_none = Q.resolve_features_fn(device="cpu")
    assert "random pyramid" in capsys.readouterr().err
    assert len(fn_none(np.zeros((1, 64, 64, 3), np.float32))) == 3


def test_quality_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """The CLI prints JAX's JSON keys and values (``--device cpu``; the
    default is the card)."""
    from PIL import Image

    rng = np.random.default_rng(2)
    for name in ("src.png", "gen.png"):
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(tmp_path / name)
    argv = ["--image", str(tmp_path / "gen.png"), "--data_path", str(tmp_path / "src.png"),
            "--self_baseline"]
    monkeypatch.delenv(Q.WEIGHTS_ENV, raising=False)
    Q.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr("sys.argv", ["quality"] + argv)
    jq.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and got["baseline_self"].keys() == want["baseline_self"].keys()
    for rep, ref in ((got, want), (got["baseline_self"], want["baseline_self"])):
        for k, v in ref.items():
            if isinstance(v, float):
                assert rep[k] == pytest.approx(v, rel=REL), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Q.main(argv)
