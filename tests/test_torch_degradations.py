"""The port's Real-ESRGAN degradation ops against the JAX package's, on the
CPU, with the JAX ops (which call OpenCV) as the oracle.

* Per op: the same input and a copy of the same generator go to the port
  op and the JAX op over enough seeds that every kernel type, resize mode
  and noise type of the shipped 002 parameters is drawn (asserted);
  outputs are held at their primitive's tolerance (filters 1e-6, resizes
  1e-5, the JPEG round trip and the noise bit for bit) and the
  generators' states are equal afterwards. The rest of the zoo likewise.
* Replay: every leaf op of the shipped 002 train pipelines (nested ones
  included) is handed the input and generator state its JAX twin got in
  a run of JAX's ``Compose``, and held as above.
* USM: a pixel whose |residual|·255 lies within 1e-4 of the threshold may
  flip its mask bit; such pixels are counted, every other output pixel is
  held at 1e-6, and the rest is bounded by the near pixels' kernel
  weight.
* Whole batches of the shipped train split through ``build_dataset`` and
  the port's loader: keys, shapes and dtypes equal JAX's for the same
  seed, and thread and process modes give the same bits.
* The registry holds every degradation name JAX's does, and the ops that
  draw raise without ``results['_rng']``.
"""

import copy
import glob
import re

import cv2
import numpy as np
import pytest

import tests.test_torch_weights as tw
from chip_smoke import smooth_picture
from ciaosr_torch.config import Config
from ciaosr_torch.config.registry import PIPELINES as PORT_PIPELINES
from ciaosr_torch.data import datasets as port_ds
from ciaosr_torch.data import degradations as port_deg
from ciaosr_torch.data import loader as port_loader
from ciaosr_torch.data import pipelines as port_pl
from ciaosr_torch.data.imageio import write_png
from ciaosr_tpu.config.registry import PIPELINES as JAX_PIPELINES
from ciaosr_tpu.data import datasets as jax_ds
from ciaosr_tpu.data import degradations as jax_deg
from ciaosr_tpu.data import loader as jax_loader
from ciaosr_tpu.data import pipelines as jax_pl
from tests.test_torch_train_data import bounded, take

SHIPPED = {name: glob.glob(str(tw.ROOT / "configs" /
                               f"002_real_{name}_*.py"))[0]
           for name in ("wogan", "gan")}
CFG = Config.fromfile(SHIPPED["wogan"])
# the shipped leaf degradation ops, by position in the train pipeline
SHIPPED_OPS = {f"{i}_{d['type']}": d for i, d in enumerate(CFG.train_pipeline)
               if d["type"] in ("RandomBlur", "RandomResize", "RandomNoise",
                                "RandomJPEGCompression")}
SHUFFLE = [d for d in CFG.train_pipeline
           if d["type"] == "DegradationsWithShuffle1"][0]
SCALE_RESIZE = dict(SHUFFLE["degradations"][1][0], keys=["lq"])
SINC_BLUR = dict(SHUFFLE["degradations"][1][1], keys=["lq"])
NESTED_JPEG = dict(SHUFFLE["degradations"][0], keys=["lq"])

TOL = {"RandomBlur": 1e-6, "RandomResize": 1e-5, "RandomScaleResize1": 1e-5,
       "RandomScaleResize": 1e-5,
       "RealRandomResize": 1e-5, "NorResize": 1e-5, "OldRandomNoise": 1e-5,
       "UVSRDegradation": 1e-6}     # every other op: bit for bit


def _image(seed, hw=(40, 44)):
    rng = np.random.default_rng(seed)
    img = smooth_picture(rng, *hw).astype(np.float32) / 255.0
    return np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1
                   ).astype(np.float32)


def _build(cfg):
    return (port_pl.build_op(dict(cfg)),
            port_pl.build_from_cfg(dict(cfg), JAX_PIPELINES))


def _hold(got, ref, tol, what=""):
    if isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), what
        for g, r in zip(got, ref):
            _hold(g, r, tol, what)
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        what, got.shape, ref.shape, got.dtype, ref.dtype)
    if tol:
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


def _run_pair(port_op, jax_op, results, seed):
    """Both ops on copies of ``results`` with copies of one generator:
    (port out, JAX out), the generators' states asserted equal."""
    rng = np.random.default_rng(seed)
    got = port_op(dict(copy.deepcopy(results), _rng=copy.deepcopy(rng)))
    ref = jax_op(dict(copy.deepcopy(results), _rng=rng))
    assert got["_rng"].bit_generator.state == \
        ref["_rng"].bit_generator.state, "the ops drew differently"
    return got, ref


@pytest.fixture
def record(monkeypatch):
    """What the port ops drew: kernel types, resize modes, noise kinds,
    JPEG qualities (by wrapping the port module's helpers)."""
    seen = {"kernel": set(), "resize": set(), "noise": set(), "jpeg": set()}
    mixed = port_deg.random_mixed_kernel

    def kernel(rng, kernel_list, kernel_prob, *a):
        seen["kernel"].add(str(copy.deepcopy(rng).choice(
            kernel_list, p=kernel_prob)))
        return mixed(rng, kernel_list, kernel_prob, *a)

    resize = port_deg.resize

    def resize_rec(img, size, interp):
        seen["resize"].add(interp)
        return resize(img, size, interp)

    jpeg = port_deg._jpeg

    def jpeg_rec(img, q):
        seen["jpeg"].add(q)
        return jpeg(img, q)

    gray = port_deg.rgb2gray

    def gray_rec(img):
        seen["noise"].add("poisson_gray")
        return gray(img)

    for cls, name in ((port_deg.RandomNoise, "_gaussian"),
                      (port_deg.RandomNoise, "_poisson")):
        fn = getattr(cls, name)

        def wrapped(self, rng, img, _fn=fn, _n=name):
            seen["noise"].add(_n[1:])
            return _fn(self, rng, img)
        monkeypatch.setattr(cls, name, wrapped)
    monkeypatch.setattr(port_deg, "random_mixed_kernel", kernel)
    monkeypatch.setattr(port_deg, "resize", resize_rec)
    monkeypatch.setattr(port_deg, "_jpeg", jpeg_rec)
    monkeypatch.setattr(port_deg, "rgb2gray", gray_rec)
    return seen


# ------------------------------------------------------------ per op --
@pytest.mark.parametrize("name", sorted(SHIPPED_OPS) + [
    "RandomScaleResize1", "sinc_RandomBlur", "nested_RandomJPEGCompression"])
def test_shipped_op_matches_jax(name, record):
    """Each leaf op of the shipped chain over 200 seeds (90 for the
    cheaper-to-cover ones): the JAX op's output at the primitive's
    tolerance, the same draws, and every kernel type / resize mode /
    noise kind of its parameters drawn."""
    cfg = {"RandomScaleResize1": SCALE_RESIZE, "sinc_RandomBlur": SINC_BLUR,
           "nested_RandomJPEGCompression": NESTED_JPEG}.get(name) or \
        SHIPPED_OPS[name]
    port_op, jax_op = _build(cfg)
    tol = TOL.get(cfg["type"], 0)
    seeds = 200 if cfg["type"] == "RandomBlur" else 90
    for seed in range(seeds):
        img = _image(seed % 7)
        res = {"lq": img, "gt": np.zeros((160, 176, 3), np.float32)}
        got, ref = _run_pair(port_op, jax_op, res, seed)
        _hold(got["lq"], ref["lq"], tol, f"{name} seed {seed}")
    p = cfg["params"]
    if cfg["type"] == "RandomBlur":
        assert record["kernel"] == set(p["kernel_list"])
    if "resize_opt" in p:
        assert record["resize"] == set(p["resize_opt"])
    if cfg["type"] == "RandomNoise":
        assert record["noise"] == {"gaussian", "poisson", "poisson_gray"}
    if cfg["type"] == "RandomJPEGCompression":
        lo, hi = p["quality"]
        assert len(record["jpeg"]) > 10 and min(record["jpeg"]) >= lo \
            and max(record["jpeg"]) < hi


class Recorder:
    """Stands in for a JAX leaf op: logs (input, the leaf's port twin,
    output), inputs deep-copied with their generator."""

    def __init__(self, jax_op, port_op, log):
        self.jax_op, self.port_op, self.log = jax_op, port_op, log

    def __call__(self, results):
        before = copy.deepcopy(results)
        out = self.jax_op(results)
        self.log.append((before, self.port_op, self.jax_op,
                         copy.deepcopy(out)))
        return out


def _wrap_leaves(jax_ops, port_ops, log):
    """Replace each leaf of a JAX op list (and of nested shuffles) by a
    Recorder paired with the port op at the same place."""
    for i, (j, p) in enumerate(zip(jax_ops, port_ops)):
        if isinstance(j, list):
            _wrap_leaves(j, p, log)
        elif isinstance(j, jax_deg.DegradationsWithShuffle):
            assert isinstance(p, port_deg.DegradationsWithShuffle)
            _wrap_leaves(j.degradations, p.degradations, log)
        else:
            assert type(p).__name__ == type(j).__name__
            jax_ops[i] = Recorder(j, p, log)


def _replay(log):
    """Each logged leaf's port twin on the leaf's JAX input and generator
    state: the outputs held, the states equal. The USM flip count."""
    flips = 0
    for before, port_op, jax_op, after in log:
        got = port_op(copy.deepcopy(before))
        name = type(jax_op).__name__
        if "_rng" in after:
            assert got["_rng"].bit_generator.state == \
                after["_rng"].bit_generator.state, name
        for key, val in after.items():
            if key == "_rng" or not isinstance(val, np.ndarray):
                continue
            if name == "UnsharpMasking" and key.endswith("_unsharp"):
                flips += hold_usm(got[key], val, before[key[:-8]], port_op)
            else:
                _hold(got[key], val, TOL.get(name, 0), f"{name}.{key}")
    return flips


def test_shuffle_matches_jax():
    """The shipped DegradationsWithShuffle1 over 24 seeds: the same
    permutation and final generator state, the port's leaves called in
    JAX's order, and each port leaf held on its JAX leaf's input (a JPEG
    after a resize sees inputs that may differ in a last bit)."""
    orders = set()
    for seed in range(24):
        port_op, jax_op = _build(SHUFFLE)
        jlog, plog = [], []
        _wrap_leaves(jax_op.degradations, port_op.degradations, jlog)
        port_twin = copy.deepcopy(port_op)
        _wrap_leaves(port_op.degradations, port_twin.degradations, plog)
        res = {"lq": _image(seed, (60, 64)),
               "gt": np.zeros((180, 192, 3), np.float32)}
        _run_pair(port_op, jax_op, res, seed)
        assert [type(e[2]).__name__ for e in jlog] == \
            [type(e[2]).__name__ for e in plog]
        orders.add(type(jlog[0][2]).__name__)
        _replay(jlog)
    assert orders == {"RandomJPEGCompression", "RandomScaleResize"}


def hold_usm(got, ref, img, op):
    """USM's output against JAX's: pixels whose |residual|·255 is within
    1e-4 of the threshold may flip their mask bit; every output pixel
    out of their reach is held at 1e-6, the rest within their kernel
    weight times |sharp − img|. The number of such near pixels."""
    blur = cv2.filter2D(img, -1, op.kernel)
    residual = img - blur
    near = np.abs(np.abs(residual) * 255 - op.threshold) <= 1e-4
    sharp = np.clip(img + op.weight * residual, 0, 1)
    reach = np.abs(cv2.filter2D(near.astype(np.float64), -1, op.kernel))
    bound = 1e-6 + reach * np.abs(sharp - img) * 1.001
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()
    return int(near.sum())


def test_usm_threshold_flips_are_bounded():
    """USM on five 400² pictures with noise (the seeds are the first five,
    not chosen): the near pixels counted and every pixel held."""
    port_op, jax_op = _build(dict(type="UnsharpMasking", keys=["gt"],
                                  kernel_size=51, sigma=0, weight=0.5,
                                  threshold=10))
    np.testing.assert_allclose(port_op.kernel, jax_op.kernel, atol=1e-15,
                               rtol=0)
    near = 0
    for seed in range(5):
        img = _image(seed, (400, 400))
        got = port_op({"gt": img.copy()})["gt_unsharp"]
        ref = jax_op({"gt": img.copy()})["gt_unsharp"]
        near += hold_usm(got, ref, img, port_op)
    print(f"USM: {near} pixels within 1e-4 of the threshold in 5 images")


# ------------------------------------------------------------ replay --
def write_df2k(root, n=3):
    """``n`` seeded 480×512 pictures under root/hr (the 400² crop draws)
    and one 48² picture under root/val; root/hr."""
    rng = np.random.default_rng(21)
    for sub, count, hw in (("hr", n, (480, 512)), ("val", 1, (48, 48))):
        (root / sub).mkdir(exist_ok=True)
        for i in range(count):
            write_png(str(root / sub / f"{i:04d}.png"),
                      smooth_picture(rng, *hw))
    return root / "hr"


NARROW_002 = """
model['generator']['encoder'].update(embed_dim=12, depths=[2],
                                     num_heads=[3])
model['generator']['imnet_q']['hidden_list'] = [16]
model['generator']['imnet_k']['hidden_list'] = [16]
model['generator']['imnet_v']['hidden_list'] = [16]
"""


def derived_002(name, root, extra=""):
    """A copy of the shipped 002 config: its text as shipped, then its
    data paths set to ``write_df2k(root)``'s folders, then ``extra``."""
    path = root / f"002_{name}_derived.py"
    path.write_text(open(SHIPPED[name]).read() + f"""
data['train']['dataset']['gt_folder'] = '{root}/hr'
data['val']['gt_folder'] = '{root}/val'
""" + extra)
    return str(path)


@pytest.fixture(scope="module")
def df2k(tmp_path_factory):
    return write_df2k(tmp_path_factory.mktemp("df2k"))


@pytest.mark.parametrize("name", ["wogan", "gan"])
def test_replay_shipped_train_pipeline(name, df2k):
    """JAX's Compose of the shipped train pipeline on two samples, every
    leaf op (top level and nested) recorded; each port twin replayed on
    its JAX twin's input and generator state."""
    pipeline = Config.fromfile(SHIPPED[name]).train_pipeline
    flips = 0
    for seed in range(2):
        jax_c, port_c = jax_pl.Compose(pipeline), port_pl.Compose(pipeline)
        log = []
        _wrap_leaves(jax_c.ops, port_c.ops, log)
        out = jax_c({"gt_path": str(df2k / f"{seed:04d}.png"),
                     "_rng": np.random.default_rng(seed)})
        assert out["lq"].shape == (64, 64, 3)
        # the shuffle's three leaves stand for it
        assert len(log) == len(pipeline) + 2
        flips += _replay(log)
    print(f"replay {name}: {flips} USM pixels near the threshold")


# ------------------------------------------------------------ the zoo --
ZOO = {
    "RandomGaussianNoise": dict(type="RandomGaussianNoise",
                                params=dict(gaussian_sigma=[1, 30],
                                            nonblind_noise=True),
                                keys=["lq", "gt"]),
    "RandomGaussianNoisewithPro": dict(
        type="RandomGaussianNoisewithPro",
        params=dict(prob=0.5, gaussian_sigma=[1, 30],
                    gaussian_beta=[30, 50]), keys=["lq"]),
    "RandomClipGaussianNoise": dict(type="RandomClipGaussianNoise",
                                    params=dict(gaussian_sigma=[1, 30]),
                                    keys=["lq"]),
    "RandomLevel": dict(type="RandomLevel", params=dict(sigma=[1, 30]),
                        keys=["lq", "gt"]),
    "RealRandomNoise": dict(
        type="RealRandomNoise",
        params=dict(noise_type=["gaussian", "poisson", "speckle", "jpeg"],
                    gaussian_sigma=[1, 30], gaussian_sigma_step=2,
                    gaussian_gray_noise_prob=0.4, poisson_scale=[0.05, 3],
                    poisson_scale_step=0.1, poisson_gray_noise_prob=0.4,
                    speckle_level=[1, 20], quality_range=[20, 90],
                    other_prob=0.7, shuffle_prob=0.5), keys=["lq"]),
    "RealRandomResize": dict(
        type="RealRandomResize",
        params=dict(resize_mode_prob=[0.4, 0.4, 0.2],
                    resize_scale=[0.5, 1.5],
                    resize_opt=["bilinear", "bicubic", "area", "lanczos"],
                    resize_prob=[0.25] * 4, is_size_even=True),
        keys=["lq"]),
    "NorResize": dict(type="NorResize",
                      params=dict(resize_opt="lanczos",
                                  resize_mode_prob=[0.5, 0.5, 0],
                                  resize_scale=[0.5, 1.5], resize_step=0.1),
                      keys=["lq"]),
    "OldRandomNoise": dict(
        type="OldRandomNoise",
        params=dict(gaussian_sigma=[1, 20], gaussian_gray_noise_prob=0.4,
                    poisson_scale=[0.05, 1], poisson_gray_noise_prob=0.4,
                    speckle_level=[1, 20], quality_range=[30, 90],
                    other_prob=1.0, shuffle_prob=0.5, blur_prob=0.5,
                    shift_prob=0.5), keys=["gt"]),
    "RandomBlur_walk": dict(
        type="RandomBlur",
        params=dict(kernel_size=[7, 9], kernel_list=["iso", "aniso"],
                    kernel_prob=[0.5, 0.5], sigma_x=[0.2, 3],
                    sigma_y=[0.2, 3], sigma_x_step=0.2, sigma_y_step=0.2,
                    rotate_angle_step=0.1), keys=["lq"]),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_op_matches_jax(name, record, monkeypatch):
    """The rest of the zoo (not in a shipped config) over 30 seeds, on a
    single frame and on a list of three frames. OldRandomNoise runs its
    16 slots on one image, a JPEG or a Poisson draw after a resize: its
    resizes take cv2's here (``resize`` is held to cv2 on its own), so
    that a last-bit difference does not reach a rounding to 8 bits."""
    cfg = ZOO[name]
    if name == "OldRandomNoise":
        codes = {"bilinear": 1, "bicubic": 2, "area": 3, "lanczos": 4}
        monkeypatch.setattr(port_deg, "resize", lambda img, size, interp:
                            cv2.resize(img, (size[1], size[0]),
                                       interpolation=codes[interp]))
    port_op, jax_op = _build(cfg)
    tol = TOL.get(cfg["type"], 0)
    for seed in range(30):
        frames = [_image(seed + i, (36, 40)) for i in range(3)]
        for lq in (frames[0], frames):
            res = {"lq": copy.deepcopy(lq), "gt": copy.deepcopy(lq)}
            got, ref = _run_pair(port_op, jax_op, res, seed)
            for key in ("lq", "gt"):
                _hold(got[key], ref[key], tol, f"{name} {seed} {key}")
    if name == "RealRandomResize":
        assert record["resize"] == {"bilinear", "bicubic", "area",
                                    "lanczos"}


def test_uvsr_and_video_compression_match_jax():
    """UVSRDegradation (MATLAB bicubic through the port's core/resize.py)
    on 8 frames; RandomVideoCompression raises JAX's ImportError without
    PyAV, and so does OldRandomNoise with a codec."""
    frames = np.stack([_image(i, (24, 28)) for i in range(8)])
    cfg = dict(type="UVSRDegradation", params=dict(scale=[2, 2, 2]),
               keys=["lq"])
    port_op, jax_op = _build(cfg)
    _hold(port_op({"lq": frames.copy()})["lq"],
          jax_op({"lq": frames.copy()})["lq"], TOL["UVSRDegradation"])
    try:
        import av  # noqa: F401
    except ImportError:
        for cfg in (dict(type="RandomVideoCompression",
                         params=dict(codec=["libx264"], bitrate=[1e4, 1e5]),
                         keys=["lq"]),
                    dict(type="OldRandomNoise", params=dict(codec=["mpeg4"]),
                         keys=["gt"])):
            with pytest.raises(ImportError, match="PyAV") as port_err:
                port_pl.build_op(dict(cfg))
            with pytest.raises(ImportError) as jax_err:
                port_pl.build_from_cfg(dict(cfg), JAX_PIPELINES)
            assert str(port_err.value) == str(jax_err.value)


def test_registry_holds_every_jax_degradation_and_ops_need_a_generator():
    src = open(jax_deg.__file__).read()
    names = set(re.findall(r'@PIPELINES\.register\(name="(\w+)"\)', src))
    assert len(names) == 18
    assert not names - set(PORT_PIPELINES._registry)
    for cfg in list(SHIPPED_OPS.values()) + [SHUFFLE, SCALE_RESIZE]:
        op = port_pl.build_op(dict(cfg))
        with pytest.raises(KeyError, match="_rng"):
            op({"lq": _image(0), "gt": _image(0)})


# ------------------------------------------------------------ batches --
@pytest.mark.parametrize("name", ["wogan", "gan"])
def test_shipped_train_split_batches(name, df2k):
    """The shipped train split (RepeatDataset of the degradation chain) on
    the seeded folder: JAX's process-mode batch and the port's have the
    same keys, shapes and dtypes; the port's thread and process modes give
    the same bits."""
    cfg = Config.fromfile(SHIPPED[name]).data["train"]
    cfg = dict(cfg, times=2, dataset=dict(cfg["dataset"],
                                          gt_folder=str(df2k)))
    kw = dict(batch_size=2, num_workers=2, seed=3)
    ref = bounded(lambda: take(jax_loader.DataLoader(
        jax_ds.build_dataset(cfg), worker_mode="process", **kw), 1), 120)[0]
    ds = port_ds.build_dataset(cfg)
    got = {mode: bounded(lambda: take(port_loader.DataLoader(
        ds, worker_mode=mode, **kw), 1), 120)[0]
        for mode in ("thread", "process")}
    assert set(got["process"]) == set(ref) == {
        "lq", "gt", "gt_unsharp", "coord", "cell", "meta"}
    for key, val in ref.items():
        if key == "meta":
            assert got["process"]["meta"] == got["thread"]["meta"]
            continue
        assert got["process"][key].shape == val.shape, key
        assert got["process"][key].dtype == val.dtype, key
        np.testing.assert_array_equal(got["process"][key],
                                      got["thread"][key])
    assert ref["lq"].shape == (2, 64, 64, 3)
    assert ref["gt"].shape == ref["gt_unsharp"].shape == (2, 4096, 3)


def test_chain_and_ssim_run_without_opencv_or_pillow():
    """The card's machine has neither: with both unimportable, the
    shipped chain's primitives and SSIM run."""
    import subprocess
    import sys
    code = (
        "import sys; sys.modules['cv2'] = None; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from ciaosr_torch.data import pipelines as pl\n"
        "from ciaosr_torch.core.metrics import ssim\n"
        "img = np.random.default_rng(0).random((60, 64, 3), np.float32)\n"
        "ops = [dict(type='UnsharpMasking', keys=['lq']),\n"
        "       dict(type='RandomBlur', params=dict(kernel_size=[21],\n"
        "            kernel_list=['sinc'], kernel_prob=[1]), keys=['lq']),\n"
        "       dict(type='RandomNoise', params=dict(noise_type=['poisson'],\n"
        "            poisson_scale=[1, 2], poisson_gray_noise_prob=1),\n"
        "            keys=['lq']),\n"
        "       dict(type='RandomJPEGCompression', params=dict(quality=[5, 9]),\n"
        "            keys=['lq']),\n"
        "       dict(type='RandomScaleResize1', params=dict(scale_min=2,\n"
        "            scale_max=3, resize_opt=['area']), keys=['lq'])]\n"
        "out = pl.Compose(ops)({'lq': img, 'gt': img,\n"
        "                       '_rng': np.random.default_rng(1)})\n"
        "assert np.isfinite(out['lq']).all()\n"
        "u8 = (img * 255).astype(np.uint8)\n"
        "assert 0 < ssim(u8, u8[::-1].copy()) < 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=tw.ROOT, check=True,
                   timeout=120)
