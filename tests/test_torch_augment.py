"""The port's augmentation against the JAX package's on the CPU: the plain
versions of the photometric kernels against the Pallas kernels (interpret
mode) and the jnp path, the whole chain given the same parameters, the
native-to-target resizes, the parameter sampler, and the padded native
cache.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).

Parameters come from the JAX sampler exactly as the JAX batch functions
draw them (``split(rng, b)``, then ``vmap(sample_augment_params)``), so
both sides apply the same draws.

Tolerances, and why:
  * photometric stages within 2e-6 inside each native extent: the
    contrast mean is summed in another order and the blur taps are
    normalised in another order;
  * the whole chain's images within CHAIN_ATOL = 1e-4: XLA on the CPU
    contracts the coordinate arithmetic into fused multiply-adds
    (``m01 = scale * fma(cos, tan, -sin)``, ``det = fma(m00, m11,
    -m01*m10)``, ...), which the port's separate, identically rounded
    operations on the card and the CPU do not, so about one coordinate in
    ten differs by an ulp; an ulp of a coordinate near 56 is 3.8e-6, which
    a bilinear sample of noise images carries into the value, twice over
    after the [-1, 1] normalize;
  * labels equal except at pixels that such an ulp moves across a
    rounding boundary of a nearest sample, at most 0.1%.
Each test prints the gaps it measured (``pytest -s``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gan_aug_pfa_torch.data import loader as tl
from gan_aug_pfa_torch.data import scanner as ts
from gan_aug_pfa_torch.data import transforms as tt
from gan_aug_pfa_torch.ops.kernels import photometric as ph
from gan_aug_pfa_tpu.data import loader as jl
from gan_aug_pfa_tpu.data import scanner as js
from gan_aug_pfa_tpu.data import transforms as jt
from gan_aug_pfa_tpu.ops.pallas_kernels import photometric as jph

SUBDIR = "Onera Satellite Change Detection Dataset"
CHAIN_ATOL = 1e-4
PHOTOMETRIC_ATOL = 2e-6
LABEL_MISMATCH_SHARE = 1e-3
SEEDS = 8  # draws per chain test
# Mixed native extents, one at full size and one with odd h and w.
SIZES = np.array([[32, 32], [25, 29], [16, 31], [31, 16]], np.int32)


def _images(b, h, w, seed):
    r = np.random.RandomState(seed)
    return (r.rand(b, h, w, 3).astype(np.float32),
            r.rand(b, h, w, 3).astype(np.float32),
            (r.rand(b, h, w) > 0.7).astype(np.int32))


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# -- the photometric kernels' plain versions -------------------------------


def _jitter_rows(order, sigma_first, seed):
    """Factors 0.7 / 1.3 (so the clips engage), the forced order, sigma
    alternating 0.1 / 1.0 from ``sigma_first``."""
    b = len(SIZES)
    r = np.random.RandomState(seed)
    factors = np.where(r.rand(b, 3) > 0.5, 1.3, 0.7).astype(np.float32)
    sigma = np.resize([sigma_first, 1.1 - sigma_first], b).astype(np.float32)
    return factors, np.full((b,), order, np.int32), sigma


_native_ref = jax.jit(jax.vmap(jt._native_photometric_one))


@pytest.mark.parametrize("order", range(6))
def test_native_plain_version_matches_pallas_kernel_and_jnp(order):
    img, _, _ = _images(len(SIZES), 32, 32, seed=order)
    for sigma_first in (0.1, 1.0):
        factors, orders, sigma = _jitter_rows(order, sigma_first, order)
        rows = np.concatenate(
            [factors, orders[:, None].astype(np.float32), sigma[:, None],
             SIZES.astype(np.float32),
             (SIZES[:, 0] * SIZES[:, 1]).astype(np.float32)[:, None]], 1)
        got = ph.photometric_native_chw(
            torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(rows)).permute(0, 2, 3, 1).numpy()
        pallas = np.asarray(jph.photometric_native_batch(
            jnp.asarray(img), jnp.asarray(rows), interpret=True))
        jnp_ref = np.asarray(_native_ref(
            jnp.asarray(img), jnp.asarray(factors), jnp.asarray(orders),
            jnp.asarray(sigma), jnp.asarray(SIZES)))
        gap = max(float(np.abs(got[i, :h, :w] - want[i, :h, :w]).max())
                  for i, (h, w) in enumerate(SIZES)
                  for want in (pallas, jnp_ref))
        print(json.dumps({"kernel": "native", "order": order,
                          "sigma_first": sigma_first, "max_gap": gap}))
        assert gap <= PHOTOMETRIC_ATOL


@pytest.mark.parametrize("order", range(6))
def test_flip_plain_version_matches_pallas_kernel(order):
    """The port's photometric_flip_chw applies the flips itself; the JAX
    photometric_flip_batch applies them in its wrapper."""
    img, _, _ = _images(4, 24, 20, seed=10 + order)
    factors, orders, sigma = _jitter_rows(order, 0.1, 10 + order)
    rows = np.concatenate(
        [factors, orders[:, None].astype(np.float32), sigma[:, None],
         np.array([[1, 1], [0, 1], [1, 0], [0, 0]], np.float32),
         np.zeros((4, 1), np.float32)], 1)
    got = ph.photometric_flip_chw(
        torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(rows))
    want = np.asarray(jph.photometric_flip_batch(
        jnp.asarray(img), jnp.asarray(rows), interpret=True))
    gap = float(np.abs(got.permute(0, 2, 3, 1).numpy() - want).max())
    print(json.dumps({"kernel": "flip", "order": order, "max_gap": gap}))
    assert gap <= PHOTOMETRIC_ATOL
    nhwc = ph.photometric_flip_batch(torch.from_numpy(img),
                                     torch.from_numpy(rows))
    assert torch.equal(nhwc, got.permute(0, 2, 3, 1))


def test_wrappers_on_cpu_use_plain_versions_without_launch():
    x = torch.rand(2, 3, 12, 10)
    rows = torch.tensor([[1.1, 0.9, 1.2, 3, 0.5, 12, 10, 120],
                         [0.8, 1.2, 0.9, 4, 0.7, 9, 7, 63]])
    before = (ph.photometric_native_chw.calls,
              ph.photometric_native_chw.launches,
              ph.photometric_flip_chw.calls, ph.photometric_flip_chw.launches)
    assert torch.equal(ph.photometric_native_chw(x, rows),
                       ph.photometric_native_reference(x, rows))
    assert torch.equal(ph.photometric_flip_chw(x, rows),
                       ph.photometric_flip_reference(x, rows))
    assert before == (ph.photometric_native_chw.calls,
                      ph.photometric_native_chw.launches,
                      ph.photometric_flip_chw.calls,
                      ph.photometric_flip_chw.launches)


@pytest.mark.parametrize("bad", ["dtype", "channels", "rows", "contiguity",
                                 "rows_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.rand(2, 3, 8, 8)
    rows = torch.zeros(2, 8)
    if bad == "dtype":
        x = x.half()
    elif bad == "channels":
        x = torch.rand(2, 4, 8, 8)
    elif bad == "rows":
        rows = torch.zeros(3, 8)
    elif bad == "contiguity":
        x = x.transpose(2, 3)
    else:
        rows = rows.double()
    for fn in (ph.photometric_native_chw, ph.photometric_flip_chw):
        with pytest.raises((TypeError, ValueError)):
            fn(x, rows)


# -- the chain ------------------------------------------------------------


_jax_native = jax.jit(jt.augment_batch_native, static_argnums=(5,))
_jax_fixed = jax.jit(jt.augment_batch)


def _check_chain(name, got, want, labels):
    gap = max(float(np.abs(g.numpy() - np.asarray(w)).max())
              for g, w in zip(got[:2], want[:2]))
    mismatch = (float((got[2].numpy() != np.asarray(want[2])).mean())
                if labels else None)
    print(json.dumps({"chain": name, "labels": labels, "max_image_gap": gap,
                      "label_mismatch_share": mismatch}))
    assert gap <= CHAIN_ATOL
    if labels:
        assert mismatch <= LABEL_MISMATCH_SHARE
    else:
        assert got[2] is None and want[2] is None


@pytest.mark.parametrize("labels", [True, False])
def test_native_chain_matches_jax_given_its_draws(labels):
    b, (hp, wp), out = 4, (48, 56), (32, 32)
    sizes = np.array([[48, 56], [41, 53], [24, 55], [47, 28]], np.int32)
    i1, i2, lb = _images(b, hp, wp, seed=3)
    for seed in range(SEEDS):
        rng = jax.random.PRNGKey(seed)
        p = jax.vmap(lambda k, s: jt.sample_augment_params(k, s[0], s[1]))(
            jax.random.split(rng, b), jnp.asarray(sizes))
        want = _jax_native(rng, i1, i2, lb if labels else None, sizes, out)
        got = tt.augment_batch_native(
            torch.from_numpy(i1), torch.from_numpy(i2),
            torch.from_numpy(lb) if labels else None,
            torch.from_numpy(sizes), out, _torch(p))
        assert got[0].shape == (b, *out, 3)
        _check_chain("native", got, want, labels)


@pytest.mark.parametrize("labels", [True, False])
def test_fixed_size_chain_matches_jax_given_its_draws(labels):
    b, h, w = 4, 48, 56
    i1, i2, lb = _images(b, h, w, seed=4)
    for seed in range(SEEDS):
        rng = jax.random.PRNGKey(seed)
        p = jax.vmap(lambda k: jt.sample_augment_params(k, h, w))(
            jax.random.split(rng, b))
        want = _jax_fixed(rng, i1, i2, lb if labels else None)
        got = tt.augment_batch(
            torch.from_numpy(i1), torch.from_numpy(i2),
            torch.from_numpy(lb) if labels else None, _torch(p))
        assert got[0].shape == (b, h, w, 3)
        _check_chain("fixed_size", got, want, labels)


def test_flips_within_the_native_extent_match_jax():
    _, _, lb = _images(4, 12, 10, seed=5)
    sizes = np.array([[12, 10], [7, 9], [12, 3], [1, 1]], np.int32)
    do_h = np.array([True, True, False, True])
    do_v = np.array([True, False, True, True])
    want = jax.vmap(jt._apply_flips_dyn)(lb, do_h, do_v, sizes[:, 0],
                                         sizes[:, 1])
    got = tt._apply_flips_dyn(
        torch.from_numpy(lb)[:, None], torch.from_numpy(do_h),
        torch.from_numpy(do_v), torch.from_numpy(sizes[:, 0]).long(),
        torch.from_numpy(sizes[:, 1]).long())[:, 0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the native -> target resizes ------------------------------------------


def test_resize_from_native_matches_jax_and_host_coordinates():
    """Extents that stress the integer arithmetic: 290 -> 96, 399 -> 128,
    200 -> 128 and the crossings between them.  lo/hi equal the host
    cache's float64 coordinates exactly; values within 1e-6 of JAX's."""
    sizes = np.array([[290, 399], [399, 200], [200, 290]], np.int32)
    out = (96, 128)
    r = np.random.RandomState(6)
    img = r.rand(3, 400, 400, 3).astype(np.float32)
    lab = (r.rand(3, 400, 400) > 0.5).astype(np.float32)
    for n in (200, 290, 399):
        for out_n in out:
            lo, hi, t = tt._bilinear_coeffs(torch.tensor([n]), out_n)
            src = (np.arange(out_n, dtype=np.float64) + 0.5) * (n / out_n)
            src = np.clip(src - 0.5, 0, n - 1)
            want_lo = np.floor(src).astype(np.int64)
            np.testing.assert_array_equal(lo[0].numpy(), want_lo)
            np.testing.assert_array_equal(hi[0].numpy(),
                                          np.minimum(want_lo + 1, n - 1))
            np.testing.assert_allclose(t[0].numpy(), src - want_lo, rtol=0,
                                       atol=1e-6)
            idx = tt._nearest_index(torch.tensor([n]), out_n)[0].numpy()
            np.testing.assert_array_equal(
                idx, np.minimum(np.arange(out_n) * n // out_n, n - 1))
    h, w = torch.from_numpy(sizes[:, 0]), torch.from_numpy(sizes[:, 1])
    got = tt.resize_from_native_bilinear(torch.from_numpy(img), h, w, out)
    want = jax.vmap(lambda x, a, b: jt.resize_from_native_bilinear(
        x, a, b, out))(img, sizes[:, 0], sizes[:, 1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    got = tt.resize_from_native_nearest(torch.from_numpy(lab), h, w, out)
    want = jax.vmap(lambda x, a, b: jt.resize_from_native_nearest(
        x, a, b, out))(lab, sizes[:, 0], sizes[:, 1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the sampler ----------------------------------------------------------


def _draw(seed, sizes):
    gen = torch.Generator().manual_seed(seed)
    return tt.sample_augment_params(gen, sizes)


def test_sampler_ranges_and_rates():
    """2,000 seeded draws over native sizes of 200-399 px: every parameter
    in the JAX package's range, translations integers bounded by 5% of the
    sample's own size, all six orders, flip rates 0.5 +- 0.05."""
    n = 2000
    sizes = torch.from_numpy(
        np.random.RandomState(7).randint(200, 400, (n, 2)))
    p = _draw(0, sizes)
    cfg = tt.AugmentConfig()
    assert set(p) == {"angle", "tx", "ty", "scale", "shear", "factors1",
                      "order1", "factors2", "order2", "sigma1", "sigma2",
                      "do_h", "do_v", "rot"}

    def within(v, lo, hi):
        return bool(((v >= lo) & (v <= hi)).all())

    assert within(p["angle"], -cfg.degrees, cfg.degrees)
    assert within(p["rot"], -cfg.rotation_degrees, cfg.rotation_degrees)
    assert within(p["scale"], cfg.scale_min, cfg.scale_max)
    assert within(p["shear"], -cfg.shear, cfg.shear)
    for key, axis in (("tx", 1), ("ty", 0)):
        v = p[key]
        assert torch.equal(v, torch.round(v))
        bound = torch.floor(cfg.translate * sizes[:, axis].float() + 0.5)
        assert bool((v.abs() <= bound).all())
        # The bound scales with each sample's size: large ones go further.
        assert float(v.abs().max()) > 0.05 * 300
    for k in ("1", "2"):
        assert within(p["factors" + k], 1 - cfg.jitter, 1 + cfg.jitter)
        assert within(p["sigma" + k], cfg.blur_sigma_min, cfg.blur_sigma_max)
        assert p["order" + k].dtype == torch.int64
        assert sorted(p["order" + k].unique().tolist()) == list(range(6))
    for key in ("do_h", "do_v"):
        assert abs(float(p[key].float().mean()) - 0.5) <= 0.05
    again, other = _draw(0, sizes), _draw(1, sizes)
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["angle"], other["angle"])


# -- the padded native cache -------------------------------------------------


def test_padded_native_dataset_matches_jax(oscd_tree):
    root = str(oscd_tree)
    got = tl.build_padded_native_dataset(
        ts.create_sample_lists(root, SUBDIR, mode="train", verbose=False),
        verbose=False)
    want = jl.build_padded_native_dataset(
        js.create_sample_lists(root, SUBDIR, "synthetic_data", mode="train",
                               verbose=False), verbose=False)
    for name in ("img1", "img2", "labels", "sizes"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.cities == want.cities
    assert got.img1.shape[1:3] == (48, 56)  # 48x52 padded to multiples of 8


def test_padded_native_dataset_repairs_size_mismatches(tmp_path, capsys):
    """img2 and the label at other sizes than img1: both brought to img1's
    extent, each with its warning, the same arrays as JAX's."""
    rng = np.random.RandomState(8)
    city = tmp_path / "x"
    city.mkdir()
    paths = {}
    for name, shape, mode in (("img1", (21, 30, 3), "RGB"),
                              ("img2", (25, 27, 3), "RGB"),
                              ("cm", (19, 33), "L")):
        paths[name] = str(city / f"{name}.png")
        Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8),
                        mode).save(paths[name])
    samples = [ts.Sample(paths["img1"], paths["img2"], paths["cm"], "x")]
    got = tl.build_padded_native_dataset(samples, verbose=False)
    out = capsys.readouterr().out
    assert "img1/img2 native sizes differ for x" in out
    assert "label native size differs for x" in out
    want = jl.build_padded_native_dataset(
        [js.Sample(paths["img1"], paths["img2"], paths["cm"], "x")],
        verbose=False)
    for name in ("img1", "img2", "labels", "sizes"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.sizes.tolist() == [[21, 30]]
