"""The port's data pipeline against the JAX package's, on an ImageFolder the
test writes (2 classes, JPEGs of two shapes): ``EvalTransform``, the
loaders, ``calib_batch(seed=3)``, ``raw_uint8`` and ``DebugLoaderGenerator``
give bitwise equal arrays (both are numpy + PIL); the native data plane
matches JAX's native path bitwise (skipped where g++ or libjpeg is
missing, as tests/test_native.py is; the JAX library's availability is
steadied against a build another process runs at the same time:
``jax_native_available``); ``synthetic_images`` gives JAX's
bytes and ``synthetic_qstate`` JAX's fields; ``device_trace`` writes a
Chrome trace."""
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from ptq4vit_tpu import native as jnative
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.utils import datasets as J
from ptq4vit_tpu.utils import synthetic as jsyn
from ptq4vit_tpu_torch import native as pnative
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.utils import datasets as P
from ptq4vit_tpu_torch.utils import synthetic as psyn
from ptq4vit_tpu_torch.utils.tracing import device_trace
from tests.torch_port_helpers import (SWIN3, TINY, jax_native_available,
                                      jax_net, jax_swin_net, np_fields,
                                      port_net)

needs_native = pytest.mark.skipif(
    not (jax_native_available() and pnative.available()),
    reason="g++/libjpeg unavailable")


@pytest.fixture(scope="module")
def imagenet_dir(tmp_path_factory):
    """train/ and val/, 2 classes each, 3 and 2 JPEGs a class, landscape
    and portrait, pixels from a seeded generator."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(5)
    for split, n in (("train", 3), ("val", 2)):
        for cls in ("n01", "n02"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (40, 52) if i % 2 else (52, 40)
                arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"img{i}.jpg", quality=90)
    return str(root)


@pytest.fixture(scope="module")
def nets():
    jnet = jax_net(TINY)
    return jnet, port_net(jnet)


def same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def batches(loader):
    return [(np.asarray(x), np.asarray(y)) for x, y in loader]


@pytest.mark.parametrize("kw", [
    dict(interpolation="bicubic", use_native="never"),
    dict(interpolation="bilinear"),
    dict(interpolation="bicubic", raw_uint8=True)],
    ids=["bicubic", "bilinear", "raw_uint8"])
def test_eval_transform_matches_jax(kw):
    rng = np.random.default_rng(1)
    tp = P.EvalTransform(32, crop_pct=0.9, mean=(0.5, 0.4, 0.3),
                         std=(0.2, 0.25, 0.3), **kw)
    tj = J.EvalTransform(32, crop_pct=0.9, mean=(0.5, 0.4, 0.3),
                         std=(0.2, 0.25, 0.3), **kw)
    assert not tp.wants_bytes
    for shape in ((50, 70, 3), (70, 50, 3), (32, 32, 3)):
        img = Image.fromarray((rng.random(shape) * 255).astype(np.uint8))
        same(tp(img), tj(img))


def test_loaders_match_jax(imagenet_dir):
    gp = P.ImageNetLoaderGenerator(imagenet_dir, "imagenet", 4, 3, 2)
    gj = J.ImageNetLoaderGenerator(imagenet_dir, "imagenet", 4, 3, 2)
    assert gp.train_set.samples == gj.train_set.samples
    for lp, lj in ((gp.test_loader(), gj.test_loader()),
                   (gp.train_loader(), gj.train_loader())):
        bp, bj = batches(lp), batches(lj)
        assert len(bp) == len(bj) == len(lp)
        for (xp, yp), (xj, yj) in zip(bp, bj):
            same(xp, xj)
            same(yp, yj)


def test_vit_calib_batch_matches_jax(imagenet_dir, nets):
    """The model's transform (native where it is available, in both) and
    the seed-3 subset of the train split."""
    jax_native_available()      # before JAX's transform asks the loader
    jnet, pnet = nets
    gp = P.ViTImageNetLoaderGenerator(imagenet_dir, "imagenet", 4, 4, 2,
                                      kwargs={"model": pnet})
    gj = J.ViTImageNetLoaderGenerator(imagenet_dir, "imagenet", 4, 4, 2,
                                      kwargs={"model": jnet})
    assert gp.test_transform.wants_bytes == gj.test_transform.wants_bytes
    xp, xj = gp.calib_batch(num=4, seed=3), gj.calib_batch(num=4, seed=3)
    assert xp.shape == (4, 3, 32, 32)
    same(xp, xj)
    for (a, ya), (b, yb) in zip(batches(gp.test_loader()),
                                batches(gj.test_loader())):
        same(a, b)
        same(ya, yb)


def test_raw_uint8_dataset_matches_jax(imagenet_dir):
    tp = P.EvalTransform(32, crop_pct=1.0, raw_uint8=True)
    tj = J.EvalTransform(32, crop_pct=1.0, raw_uint8=True)
    dp = P.ImageFolderDataset(imagenet_dir + "/val", tp)
    dj = J.ImageFolderDataset(imagenet_dir + "/val", tj)
    (xp, yp), = batches(P.Loader(dp, 4, num_workers=2))
    (xj, yj), = batches(J.Loader(dj, 4, num_workers=2))
    assert xp.dtype == np.uint8
    same(xp, xj)
    same(yp, yj)


@pytest.mark.parametrize("name", ["debug0", "debug1", "debug2", "debug3"])
def test_debug_loader_matches_jax(name):
    gp = P.DebugLoaderGenerator("", name, 1, 1, 1)
    gj = J.DebugLoaderGenerator("", name, 1, 1, 1)
    for (a, ya), (b, yb) in zip(batches(gp.test_loader()),
                                batches(gj.test_loader())):
        same(a, b)
        same(ya, yb)
    same(gp.calib_batch(num=1), gj.calib_batch(num=1))


def test_get_dataset_and_n_correct():
    class Args:
        dataset = "debug1"
    train, test = P.get_dataset(Args())
    (x, y), = batches(test)
    assert x.shape == (1, 1, 8, 8)
    out = np.eye(3, dtype=np.float32)[[0, 2, 1]]
    t = np.array([0, 2, 2])
    assert P.calculate_n_correct(out, t) == J.calculate_n_correct(out, t) \
        == 2


@needs_native
def test_native_matches_jax_native():
    """Resize, decode + preprocess and preprocess of decoded RGB, bitwise
    against the JAX package's library."""
    rng = np.random.default_rng(2)
    for (h, w), (oh, ow) in (((57, 83), (32, 47)), ((40, 40), (96, 96))):
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        same(pnative.resize_bicubic(arr, ow, oh),
             jnative.resize_bicubic(arr, ow, oh))
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    arr = (rng.random((60, 90, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    jpeg = buf.getvalue()
    same(pnative.decode_preprocess(jpeg, 36, 32, mean, std),
         jnative.decode_preprocess(jpeg, 36, 32, mean, std))
    same(pnative.preprocess_rgb(arr, 36, 32, mean, std),
         jnative.preprocess_rgb(arr, 36, 32, mean, std))


@needs_native
def test_native_loader_matches_jax_native(imagenet_dir):
    tp = P.EvalTransform(32, crop_pct=0.9)
    tj = J.EvalTransform(32, crop_pct=0.9)
    assert tp.wants_bytes and tj.wants_bytes
    dp = P.ImageFolderDataset(imagenet_dir + "/train", tp)
    dj = J.ImageFolderDataset(imagenet_dir + "/train", tj)
    for (a, ya), (b, yb) in zip(batches(P.Loader(dp, 4, num_workers=2)),
                                batches(J.Loader(dj, 4, num_workers=2))):
        same(a, b)
        same(ya, yb)


@needs_native
def test_native_library_lands_in_the_build_dir():
    path = pnative.library_path()
    assert path.startswith(pnative.BUILD_DIR)
    assert path.endswith(".so")


_RACE = r"""
import json, os, sys, time
root, out, i = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
from ptq4vit_tpu import native as jn
from ptq4vit_tpu_torch import native as pn
from tests.torch_port_helpers import jax_native_available
jn._SO = os.path.join(out, "jax", "libptq4vitpp.so")
pn.BUILD_DIR = os.path.join(out, "port")
open(os.path.join(out, "ready" + i), "w").close()
while not os.path.exists(os.path.join(out, "go")):
    time.sleep(0.005)
first = jn.available()
print(json.dumps([first, jax_native_available(), pn.available()]))
"""


def test_jax_native_steadied_under_concurrent_builds(tmp_path):
    """Six processes ask at once, against empty build directories (the JAX
    library's path and the port's build dir moved under tmp_path): each
    process's first JAX call may lose to another's g++, and every one of
    them reports the library available through jax_native_available."""
    if not pnative.available():
        pytest.skip("g++/libjpeg unavailable")
    (tmp_path / "jax").mkdir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n = 6
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACE, root, str(tmp_path), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]
    try:
        t0 = time.monotonic()
        while not all((tmp_path / f"ready{i}").exists() for i in range(n)):
            assert all(p.poll() is None for p in procs), \
                [p.communicate()[1][-2000:] for p in procs if p.poll()]
            assert time.monotonic() - t0 < 240
            time.sleep(0.02)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    res = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert all(steady and port for _, steady, port in res), res
    assert (tmp_path / "jax" / "libptq4vitpp.so").exists()


def test_synthetic_images_are_jax_s():
    for n, size, seed in ((2, 32, 0), (3, 16, 7)):
        a, b = psyn.synthetic_images(n, size, seed), jsyn.synthetic_images(
            n, size, seed)
        same(a, b)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_synthetic_qstate_matches_jax(kind):
    """Every op's QP kind, scalar fields and arrays (bitwise: the same
    absmax and true divisions on the same weights)."""
    jnet = jax_net(TINY) if kind == "vit" else jax_swin_net(SWIN3)
    pnet = port_net(jnet)
    jq = jsyn.synthetic_qstate(jnet, jptq4vit())
    pq = psyn.synthetic_qstate(pnet, pptq4vit())
    assert list(pq) == list(jq)
    for n in jq:
        assert type(pq[n]).__name__ == type(jq[n]).__name__
        a, b = np_fields(pq[n]), np_fields(jq[n])
        assert a.keys() == b.keys(), n
        for k in a:
            assert a[k].shape == b[k].shape, (n, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{n}.{k}")
        for f, v in vars(jq[n]).items():
            if not hasattr(v, "shape"):
                assert getattr(pq[n], f) == v, (n, f)
    with torch.no_grad():
        out = pnet.apply(torch.zeros(1, 3, 32, 32), qstate=pq)
    assert torch.isfinite(out).all()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path), "cpu"):
        torch.ones(8).sum()
    with device_trace(str(tmp_path), "cpu", name="again"):
        torch.ones(8).sum()
    files = sorted(p.name.split(".")[0] for p in tmp_path.glob("*.json"))
    assert files == ["again", "trace"]
    for p in tmp_path.glob("*.json"):
        assert "traceEvents" in json.loads(p.read_text())
