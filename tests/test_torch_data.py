"""The port's data layer against the JAX package's, on the CPU.

* ``data/augment.py``: the port computes OpenCV's bilinear resize and
  Pillow's colour enhancers and HSV conversion in numpy; the JAX package
  calls OpenCV and Pillow. Held within one grey level (the share of equal
  pixels is printed; it is 1.0 on this host), on a 376 x 1241 KITTI frame
  and on sizes that take OpenCV's 2x2 box path, and for the jitter in each
  of the 24 orders of its four ops with factors at both ends of their
  ranges; the generator's next draw equal after the call.
* ``data/kitti.py`` and ``data/nuscenes.py`` on trees in the reference's
  on-disk formats, written from a seed by ``chip_smoke.write_kitti_tree``
  / ``write_nuscenes_tree`` (after JAX ``tests/test_fixtures.py``): train,
  val and test at ``tiny_config``, with ``use_gnn_embedding`` and
  ``use_amplitude_menu``: every key ``np.array_equal`` to the JAX sample's
  but ``img``, within 1/255. The calib parse bit-equal to JAX's.
* ``chip_smoke.INPUTS_SPLIT_SHA256``: the digests of phase 21's
  ``[inputs_split]`` (the first 8 test samples of the full-size trees, as
  the CLIs build them) against the port's samples here.
* ``cli.common``: ``--dataset kitti`` / ``nuscenes`` build the JAX
  package's configuration and dataset.
"""

import argparse
import itertools

import numpy as np
import pytest

import chip_smoke
from cmr_agent_tpu.cli import common as jax_common
from cmr_agent_tpu.config import nuscenes_config as jax_nuscenes_config
from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.data import augment as jax_augment
from cmr_agent_tpu.data import kitti as jax_kitti
from cmr_agent_tpu.data import label_mapping as jax_label_mapping
from cmr_agent_tpu.data import nuscenes as jax_nuscenes
from cmr_agent_tpu.data import pipeline as jax_pipeline
from cmr_agent_tpu.native import get_fast_host_ops as jax_host_ops
from cmr_agent_tpu_torch import data as port_data
from cmr_agent_tpu_torch.cli import common
from cmr_agent_tpu_torch.config import nuscenes_config, tiny_config
from cmr_agent_tpu_torch.data import augment, kitti, label_mapping, nuscenes
from cmr_agent_tpu_torch.data import pipeline
from cmr_agent_tpu_torch.native import get_fast_host_ops

# the tiny trees: half-size images of 70 x 150 (odd full sizes: OpenCV's
# bilinear path) hold the 64 x 128 crop; nuScenes images are pre-cropped
KITTI_TINY = dict(seqs=("00", "01", "09", "10"), frames=3, h=141, w=301,
                  n_pts=5000)
NUSC_TINY = dict(count=4, n_pts=1500, h=64, w=128)


def _equal_share(got, want):
    return float(np.mean(got == want))


def _close_images(got, want, scale=1.0):
    """Within one grey level; prints the share of equal values."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64)) * scale
    print(f"equal share {_equal_share(got, want):.6f}, max diff "
          f"{diff.max():.6f}")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert diff.max() <= 1.0 + 1e-6


@pytest.mark.parametrize("shape", [(376, 1241), (375, 1242), (90, 160),
                                   (33, 65), (7, 9)])
def test_resize_image_matches_opencv(shape):
    rng = np.random.default_rng(shape[1])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    got, want = augment.resize_image(img, 0.5), jax_augment.resize_image(
        img, 0.5)
    _close_images(got, want)
    if shape == (376, 1241):
        assert got.shape == (188, 620, 3)


def test_resize_image_takes_uint8_hwc_only():
    for bad in (np.zeros((8, 8, 3), np.float32), np.zeros((8, 8), np.uint8)):
        with pytest.raises(TypeError):
            augment.resize_image(bad, 0.5)


class _Scripted:
    """A generator stand-in that gives ``color_jitter`` one order and one
    factor per op."""

    def __init__(self, order, factors):
        self.order, self.factors = list(order), list(factors)

    def permutation(self, n):
        return np.asarray(self.order)

    def uniform(self, lo, hi):
        return self.factors.pop(0)


@pytest.mark.parametrize("end", ["low", "high", "mid"])
def test_color_jitter_every_order_matches_pillow(end):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    img[:8] = 255        # saturated rows: the extrapolating blends clip
    img[8:16] = 0
    img[16:24, :, 1:] = img[16:24, :, :1]    # grey rows: no hue
    shares = []
    for order in itertools.permutations(range(4)):
        ranges = {0: (0.8, 1.2), 1: (0.8, 1.2), 2: (0.8, 1.2),
                  3: (-0.1, 0.1)}
        factors = [{"low": ranges[o][0], "high": ranges[o][1],
                    "mid": float(rng.uniform(*ranges[o]))}[end]
                   for o in order]
        got = augment.color_jitter(_Scripted(order, factors), img)
        want = jax_augment.color_jitter(_Scripted(order, factors), img)
        _close_images(got, want)
        shares.append(_equal_share(got, want))
    print(f"{end}: equal share over the 24 orders min {min(shares):.6f}")


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_keeps_the_generator_in_step(seed):
    img = np.random.default_rng(seed).integers(0, 256, (40, 60, 3),
                                               dtype=np.uint8)
    r_port, r_jax = (np.random.default_rng(seed) for _ in range(2))
    _close_images(augment.color_jitter(r_port, img),
                  jax_augment.color_jitter(r_jax, img))
    assert r_port.integers(1 << 62) == r_jax.integers(1 << 62)


def test_pipeline_helpers_match_jax():
    K = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157],
                  [0, 0, 1.0]])
    for fn, args in ((pipeline.camera_matrix_scaling, (K, 0.5)),
                     (pipeline.camera_matrix_cropping, (K, 53, 14))):
        want = getattr(jax_pipeline, fn.__name__)(*args)
        assert np.array_equal(fn(*args), want)
    for n_in, n_out in ((5000, 2048), (2048, 2048), (700, 2048), (3, 20)):
        r1, r2 = np.random.default_rng(n_in), np.random.default_rng(n_in)
        assert np.array_equal(pipeline.downsample_indices(r1, n_in, n_out),
                              jax_pipeline.downsample_indices(r2, n_in,
                                                              n_out))
        assert r1.random() == r2.random()


def test_calib_parse_is_bit_equal(tmp_path):
    rng = np.random.default_rng(5)
    lines = [ln[4:] for ln in chip_smoke.KITTI_CALIB_TXT.splitlines()]
    lines += [" ".join(f"{v:.12e}" for v in rng.normal(size=12) * 10.0 ** e)
              for e in (-7, 0, 3)]
    lines += [" ".join(repr(float(v)) for v in rng.normal(size=12))]
    for text in lines:
        want = np.fromstring(text, sep=" ").reshape(3, 4)
        assert np.array_equal(kitti.parse_calib_line(text), want)
    chip_smoke.write_kitti_tree(str(tmp_path), seqs=("05",), frames=0)
    got, want = kitti.KittiCalib(str(tmp_path)), jax_kitti.KittiCalib(
        str(tmp_path))
    assert got.matrices.keys() == want.matrices.keys() == {5}
    for key, m in want.matrices[5].items():
        assert got.get(5, key).dtype == m.dtype
        assert np.array_equal(got.get(5, key), m), key


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    k, n = str(root / "kitti"), str(root / "nuscenes")
    chip_smoke.write_kitti_tree(k, **KITTI_TINY)
    chip_smoke.write_nuscenes_tree(n, **NUSC_TINY)
    return {"kitti": k, "nuscenes": n}


def _assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "img":
            _close_images(g, w, scale=255.0)
        else:
            assert np.array_equal(g, w), key


def _datasets(name, root, mode, native=False, **over):
    jcfg = jax_tiny_config(dataset_root=root, **over)
    cfg = tiny_config(dataset_root=root, **over)
    jops = jax_host_ops() if native else (None, None)
    ops = get_fast_host_ops() if native else (None, None)
    if name == "kitti":
        return (kitti.KittiDataset(cfg, mode, *ops),
                jax_kitti.KittiDataset(jcfg, mode, *jops))
    return (nuscenes.NuScenesDataset(cfg, mode, False, *ops),
            jax_nuscenes.NuScenesDataset(jcfg, mode, False, *jops))


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_kitti_samples_match_jax(trees, mode):
    got_ds, want_ds = _datasets("kitti", trees["kitti"], mode)
    assert len(got_ds) == len(want_ds) == {"train": 12, "val": 12,
                                           "test": 12}[mode]
    assert got_ds.entries == want_ds.entries
    for epoch in (0, 2):
        got_ds.set_epoch(epoch)
        want_ds.set_epoch(epoch)
        for i in (0, 1, len(got_ds) - 1):
            _assert_samples_equal(got_ds[i], want_ds[i])


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_nuscenes_samples_match_jax(trees, mode):
    got_ds, want_ds = _datasets("nuscenes", trees["nuscenes"], mode)
    assert len(got_ds) == len(want_ds) == 4
    for i in range(len(got_ds)):
        got = got_ds[i]
        _assert_samples_equal(got, want_ds[i])
    assert got["pc_intensity"].shape == (2048,)


@pytest.mark.parametrize("name", ["kitti", "nuscenes"])
def test_gnn_knn_and_native_ops_match_jax(trees, name):
    """``use_gnn_embedding`` adds the host knn ``pc_knn``; both packages'
    native FPS and 1-NN (the CLIs' host ops) give the same samples."""
    got_ds, want_ds = _datasets(name, trees[name], "train", native=True,
                                use_gnn_embedding=True)
    for i in (0, 3):
        got = got_ds[i]
        assert got["pc_knn"].shape == (2048, 8)
        _assert_samples_equal(got, want_ds[i])


@pytest.mark.parametrize("mode", ["train", "test"])
def test_nuscenes_amplitude_menu_matches_jax(trees, mode):
    cfg = tiny_config(dataset_root=trees["nuscenes"])
    jcfg = jax_tiny_config(dataset_root=trees["nuscenes"])
    got_ds = nuscenes.NuScenesDataset(cfg, mode, use_amplitude_menu=True)
    want_ds = jax_nuscenes.NuScenesDataset(jcfg, mode,
                                           use_amplitude_menu=True)
    for i in range(len(got_ds)):
        _assert_samples_equal(got_ds[i], want_ds[i])


def test_nuscenes_pads_a_small_cloud(trees, tmp_path):
    """A raw cloud smaller than ``num_pt`` takes the repeat-and-top-up
    branch: every raw point at least once, intensity on the same rows."""
    got_ds, want_ds = _datasets("nuscenes", trees["nuscenes"], "test")
    s = got_ds[0]
    _assert_samples_equal(s, want_ds[0])
    raw = np.load(f"{trees['nuscenes']}/test/PC/000000.npy")
    assert raw.shape[1] < 2048
    assert set(np.unique(s["pc_intensity"])) == set(np.unique(raw[3]))


def test_split_digests_match_the_chip_constants(tmp_path):
    """Phase 21's ``[inputs_split]`` constants: the first 8 test samples of
    the full-size trees (sequence 09's first 4 frames, 8 nuScenes test
    triplets: the rest of the trees does not reach them), built as the
    CLIs build them."""
    k, n = str(tmp_path / "kitti"), str(tmp_path / "nuscenes")
    chip_smoke.write_kitti_tree(k, seqs=("09",), frames=4)
    chip_smoke.write_nuscenes_tree(n, count=chip_smoke.INPUTS_SPLIT_N,
                                   subs=("test",))
    got = chip_smoke.inputs_split_digests({"kitti": k, "nuscenes": n})
    assert got == chip_smoke.INPUTS_SPLIT_SHA256


@pytest.mark.parametrize("name", ["kitti", "nuscenes"])
def test_cli_builds_the_jax_config_and_dataset(trees, name):
    argv = ["--dataset", name, "--data-root", trees[name]]
    args = common.add_common_args(argparse.ArgumentParser()).parse_args(argv)
    jargs = jax_common.add_common_args(argparse.ArgumentParser()).parse_args(
        argv)
    cfg, jcfg = common.build_config(args), jax_common.build_config(jargs)
    for field in ("name", "dataset_root", "cropped_img_h", "cropped_img_w",
                  "val_interval", "epoch", "step_size", "num_workers",
                  "nlabel", "num_pt", "num_node"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    ds = common.build_dataset(cfg, args, "test")
    jds = jax_common.build_dataset(jcfg, jargs, "test")
    assert type(ds).__name__ == type(jds).__name__
    assert len(ds) == len(jds)


def test_nuscenes_config_widths():
    cfg, jcfg = nuscenes_config(), jax_nuscenes_config()
    assert (cfg.image_h, cfg.image_w) == (40, 80)
    for prop in ("image_h", "image_w", "h_proxy", "w_proxy", "num_img_proxy",
                 "num_pixel"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop


def test_label_mappings_and_exports_match_jax():
    for name in ("semantic-kitti", "nuscenes"):
        assert (label_mapping.load_label_mapping(name)
                == jax_label_mapping.load_label_mapping(name))
    from cmr_agent_tpu import data as jax_data
    assert set(port_data.__all__) == {
        n for n in dir(jax_data) if not n.startswith("_")
        and callable(getattr(jax_data, n))}
