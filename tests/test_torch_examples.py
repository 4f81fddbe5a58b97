"""The port's basic experiment script, ``examples/torch_test_vit.py``, on
the CPU: ``experiment_basic`` with ``--synthetic --quick`` on a tiny
MODEL_ZOO row (resumable through ``--checkpoint_dir``), its argument
parser, and the spawned worker queue with one ``CUDA_VISIBLE_DEVICES``
per worker."""
import os
import sys

import pytest

from ptq4vit_tpu_torch.models import registry as preg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_test_vit as tv  # noqa: E402

TINY_NAME = "vit_test_patch8_32"
TINY_ROW = dict(kind="vit", mean=(0.5,) * 3, std=(0.5,) * 3, img=32,
                patch=8, dim=24, depth=2, heads=3, crop_pct=1.0)


@pytest.fixture
def tiny_zoo(monkeypatch):
    monkeypatch.setitem(preg.MODEL_ZOO, TINY_NAME, TINY_ROW)


def test_parse_args_has_device_and_checkpoint_dir():
    args = tv.parse_args(argv=["--synthetic", "--quick", "--device", "cpu",
                               "--checkpoint_dir", "/x", "--calib_size", "8"])
    assert (args.device, args.checkpoint_dir, args.calib_size) == \
        ("cpu", "/x", 8)
    assert args.synthetic and args.quick and not args.multiprocess
    assert tv.parse_args(argv=[]).device is None          # the card


def test_experiment_basic_synthetic_quick(tiny_zoo, tmp_path):
    """Build, calibrate, evaluate; the second run resumes every op from the
    checkpoint directory and gives the same qstate."""
    args = tv.parse_args(argv=["--synthetic", "--quick", "--device", "cpu",
                               "--calib_size", "8", "--max_iteration", "1",
                               "--checkpoint_dir", str(tmp_path / "ck")])
    out = tv.experiment_basic(net=TINY_NAME, config="PTQ4ViT", args=args)
    net, qstate = out["net"], out["qstate"]
    assert set(qstate) == {n for n, _ in net.op_inventory}
    assert set(out["report"].search_seconds) == set(qstate)
    assert out["calib"].shape == (8, 3, 32, 32)
    assert 0.0 <= out["accuracy"] <= 1.0
    again = tv.experiment_basic(net=TINY_NAME, config="PTQ4ViT", args=args)
    assert again["report"].search_seconds == {}
    for n, qp in qstate.items():
        for f, v in vars(qp).items():
            w = getattr(again["qstate"][n], f)
            assert (v == w) if not hasattr(v, "shape") else bool(
                (v == w).all()), (n, f)


def _record_card(tag=None, out_dir=None):
    # the experiment body: which card this worker was given
    with open(os.path.join(out_dir, f"{tag}.card"), "w") as f:
        f.write(os.environ.get("CUDA_VISIBLE_DEVICES", ""))


def test_multiprocess_one_card_per_worker(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5")
    cfg_list = [{"tag": f"t{i}", "out_dir": str(tmp_path)} for i in range(4)]
    tv.multiprocess(_record_card, cfg_list, n_workers=2)
    cards = {p.name: p.read_text() for p in tmp_path.glob("*.card")}
    assert sorted(cards) == [f"t{i}.card" for i in range(4)]
    assert set(cards.values()) <= {"4", "5"}
