"""chip_smoke.py's phase functions at tiny sizes on the CPU, and its
card-vs-reference comparisons as ``gpu`` tests that run on a card.

``main()`` must refuse a CPU device and print no result; the phases are
called directly with small shapes so their control flow and checks run
here. The ``gpu`` tests call the same comparison functions chip_smoke's
phase 5 calls, against the host CPU device.
"""

import json

import jax
import numpy as np
import pytest

import chip_smoke as cs


def _cpu():
    return jax.devices("cpu")[0]


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and out.strip() == ""


def test_image_agreement():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.1, 1.0, (100, 3))
    assert cs.image_agreement(a, a) == (1.0, 0.0)
    b = a.copy()
    b[:10] *= 2.0  # ten diverged pixels
    frac, rel_mae = cs.image_agreement(b, a)
    assert frac == pytest.approx(0.9)
    assert rel_mae == pytest.approx(
        np.mean(np.abs(b - a)) / np.mean(a), rel=1e-9)


def test_hit_agreement_allows_ties_only():
    t = np.array([1.0, 2.0, 5.0, 1e30])
    p = np.array([3, 4, 5, -1])
    res = cs._hit_agreement(t, np.array([3, 7, 5, -1]), t, p, 1e-6, "x")
    assert res["tie_winners"] == 1 and res["hits"] == 3
    with pytest.raises(cs.CheckFailed):  # winner at another distance
        cs._hit_agreement(t + [0, 0, 1e-3, 0], p, t, p, 1e-6, "x")
    with pytest.raises(cs.CheckFailed):  # a hit in one only
        cs._hit_agreement(t, np.array([3, 4, -1, -1]), t, p, 1e-6, "x")


def test_cli_phase_tiny(tmp_path):
    res = cs.cli_phase("frequency", str(tmp_path), width=32, height=32,
                       spp=6)
    assert res["records"] > 0
    assert res["loss_tail"] < res["loss_first"]
    assert np.isfinite(res["warm_ms_per_frame"])


def test_mlp_chain_timing_tiny():
    infer_ms, train_ms = cs.mlp_chain_timing(n_query=256, batch=128,
                                             reps=2)
    assert infer_ms > 0 and train_ms > 0


@pytest.mark.parametrize(
    "compare,kw",
    [
        (cs.compare_nocache_frame, {"res": 16}),
        (cs.compare_mlp_train_step, {"batch": 256}),
        (cs.compare_bruteforce, {"n_rays": 512}),
    ],
    ids=["nocache_frame", "mlp_train_step", "bruteforce"],
)
def test_comparisons_cpu_vs_cpu(compare, kw):
    """The phase-5 comparisons run end to end here (CPU against itself,
    which must agree exactly)."""
    res = compare(_cpu(), _cpu(), **kw)
    json.dumps(res)  # printable
    if "rel_mae" in res:
        assert res["rel_mae"] == 0.0 and res["pixels_close"] == 1.0
    if "loss_rel" in res:
        assert res["loss_rel"] == 0.0
    if "tie_winners" in res:
        assert res["tie_winners"] == 0 and res["max_t_rel"] == 0.0


def test_multi_phase_virtual_cpu_mesh():
    res = cs.multi_phase(4, width=32, height=32, tile=4, frames=4)
    assert res["table_devices"] == 4 and res["image_shard_devices"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize(
    "compare",
    [cs.compare_nocache_frame, cs.compare_mlp_train_step,
     cs.compare_bruteforce],
    ids=["nocache_frame", "mlp_train_step", "bruteforce"],
)
def test_card_vs_cpu(gpu_device, compare):
    compare(gpu_device, _cpu())


def test_big_scene_phase_tiny():
    """Wide BVH, compact-once, raster and native builder at 32x32, with
    the raster-vs-walk parity check."""
    res = cs.big_scene_phase(width=32, height=32, frames=2)
    assert res["triangles"] > 16384 and res["hits"] > 0
