"""The port's yardstick: device specs (`obs/devicespec.py`), the peak and
MFU (`utils/flops.py`), the roofline and record block (`obs/costmodel.py`)
against the JAX package's, and bench.py's other readers, the step timer
(`utils/profiling.py`) and the deadlined child and device probe
(`utils/procwatch.py`).

The verdicts and the TPU rows equal the JAX package's
(`tests/test_costmodel.py::test_roofline_verdicts_and_mfu`,
`test_device_specs`); the card's row is the H100 SXM's published dense
bf16 rate and HBM3 bandwidth. Off the card the peak is 0.0 and the MFU
None, the JAX contract.
"""

import os
import sys

import numpy as np
import pytest
import torch

from eventgrad_tpu.obs import costmodel as jax_costmodel
from eventgrad_tpu.obs import devicespec as jax_devicespec
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.obs import costmodel
from eventgrad_tpu_torch.obs.devicespec import (
    GENERIC_CPU, GPU_SPECS, H100, TPU_SPECS, DeviceSpec, device_spec,
    spec_for_kind,
)
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils import flops, procwatch, profiling

CARD = "NVIDIA H100 80GB HBM3"


def test_tpu_rows_are_the_jax_table():
    assert [(s, d.name, d.peak_flops, d.peak_hbm_bytes_per_s, d.nominal)
            for s, d in TPU_SPECS] == [
        (s, d.name, d.peak_flops, d.peak_hbm_bytes_per_s, d.nominal)
        for s, d in jax_devicespec.TPU_SPECS]
    j = jax_devicespec.GENERIC_CPU
    assert (GENERIC_CPU.name, GENERIC_CPU.peak_flops,
            GENERIC_CPU.peak_hbm_bytes_per_s, GENERIC_CPU.nominal) == (
        j.name, j.peak_flops, j.peak_hbm_bytes_per_s, j.nominal)


def test_device_specs():
    # the JAX package's verdicts
    for platform, kind in (("tpu", "TPU v5 lite"), ("tpu", "TPU v4"),
                           ("cpu", "cpu"), ("tpu", "TPU v99 hyperlite"),
                           ("tpu", None), (None, None)):
        want = jax_devicespec.spec_for_kind(platform, kind)
        got = spec_for_kind(platform, kind)
        assert (got.name, got.peak_flops) == (want.name, want.peak_flops)
    assert spec_for_kind("tpu", "TPU v5 lite").peak_flops == 197e12
    assert spec_for_kind("cpu", "cpu") is GENERIC_CPU
    assert GENERIC_CPU.nominal
    # the card: the H100 SXM row under either platform word
    for platform in ("gpu", "cuda"):
        assert spec_for_kind(platform, CARD) is H100
    assert spec_for_kind("tpu", CARD) is GENERIC_CPU
    assert spec_for_kind("gpu", "NVIDIA A100-SXM4-80GB") is GENERIC_CPU
    assert (H100.name, H100.peak_flops, H100.peak_hbm_bytes_per_s,
            H100.peak_tf32_flops, H100.peak_f32_flops) == (
        "nvidia-h100-sxm", 989e12, 3.35e12, 495e12, 67e12)
    assert not H100.nominal and dict(GPU_SPECS)["h100"] is H100
    assert device_spec("cpu") is GENERIC_CPU
    if not torch.cuda.is_available():
        assert device_spec() is GENERIC_CPU
    # the one spec table: utils.flops reads its peaks from it
    peaks = dict(flops.PEAK_FLOPS_BY_KIND)
    assert peaks["v5 lite"] == 197e12 and peaks["h100"] == 989e12


def test_device_spec_reads_the_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: CARD)
    assert device_spec("cuda") is H100
    assert flops.chip_peak_flops("cuda") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Unknown GPU")
    assert device_spec("cuda") is GENERIC_CPU
    assert flops.chip_peak_flops("cuda") == 0.0


def test_chip_peak_is_zero_on_cpu_and_mfu_none():
    assert flops.chip_peak_flops("cpu") == 0.0
    assert flops.mfu(1e12, 0.001, "cpu") is None
    if not torch.cuda.is_available():
        assert flops.chip_peak_flops() == 0.0
        assert flops.mfu(1e12, 0.001) is None


def test_mfu_quotient(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: CARD)
    assert flops.mfu(989e9, 0.001, "cuda") == pytest.approx(1.0)
    assert flops.mfu(0.0, 0.001, "cuda") is None
    assert flops.mfu(1e9, 0.0, "cuda") is None


ROOFLINE_CASES = [
    (200.0, 10.0, 2.0), (5.0, 10.0, 1.0), (0.0, 0.0, 0.0), (7.0, 0.0, 1.0),
    (3e12, 4e11, 0.25),
]


@pytest.mark.parametrize("case", ROOFLINE_CASES)
def test_roofline_and_record_block_equal_jax(case):
    spec = DeviceSpec("t", peak_flops=100.0, peak_hbm_bytes_per_s=10.0)
    jspec = jax_devicespec.DeviceSpec("t", peak_flops=100.0,
                                      peak_hbm_bytes_per_s=10.0)
    got, want = costmodel.roofline(*case, spec), \
        jax_costmodel.roofline(*case, jspec)
    assert got == want
    cm = {"flops_total": case[0], "hbm_bytes_total": case[1],
          "by_phase": {"grad": {"flops": 1.4, "hbm_bytes": 2.6},
                       "other": {"flops": 0.0, "hbm_bytes": 0.0}}}
    assert costmodel.record_block(cm, got) == \
        jax_costmodel.record_block(cm, want)


def test_roofline_verdicts_and_mfu():
    spec = DeviceSpec("t", peak_flops=100.0, peak_hbm_bytes_per_s=10.0)
    assert spec.ridge_intensity == 10.0
    r = costmodel.roofline(200.0, 10.0, 2.0, spec)
    assert r["roofline_bound"] == "compute"
    assert r["mfu"] == pytest.approx(1.0)
    assert r["roofline_frac"] == pytest.approx(1.0)
    r = costmodel.roofline(5.0, 10.0, 1.0, spec)
    assert r["roofline_bound"] == "memory"
    assert r["achieved_bytes_per_s"] == pytest.approx(10.0)
    assert r["roofline_frac"] == pytest.approx(1.0)
    assert r["mfu"] == pytest.approx(0.05)
    r = costmodel.roofline(0.0, 0.0, 0.0, spec)
    assert r["mfu"] is None and r["roofline_bound"] is None
    # the card's ridge: 989 TFLOP/s over 3.35 TB/s
    assert H100.ridge_intensity == pytest.approx(989e12 / 3.35e12)


def test_compiled_flops_and_train_step_flops():
    """The cost model stands in for XLA's cost analysis: a matmul's
    2·n^3, 0.0 for a call that cannot be traced, and a train step's
    FLOPs above 2x the ranks' forward passes (forward + backward; the
    2-layer MLP's backward skips the input gradient of its first
    layer)."""
    a = torch.ones((64, 64))
    assert flops.compiled_flops(lambda x: x @ x, a) == 2 * 64 ** 3
    assert flops.compiled_flops(lambda x: x / 0 + [], a) == 0.0
    model = MLP(hidden=64, input_shape=(28, 28, 1), device="cpu")
    topo = Ring(4)
    state = init_train_state(model, (28, 28, 1), topo, "dpsgd", device="cpu")
    x = np.zeros((32, 28, 28, 1), np.float32)
    y = np.zeros((32,), np.int64)
    step_f = flops.train_step_flops(model, topo, "dpsgd", EventConfig(), x,
                                    y, 8, state)
    p0 = arena_spec(model).unravel(state.params[0])
    fwd = flops.compiled_flops(
        lambda p, xb: torch.func.functional_call(model, p, (xb, {}, False)),
        p0, torch.zeros((8, 28, 28, 1)))
    assert step_f > 2.0 * 4 * fwd > 0


# --- profiling ---------------------------------------------------------------


def test_timed_steps_on_the_cpu():
    model = MLP(hidden=8, input_shape=(8, 8, 1), device="cpu")
    topo = Ring(2)
    state = init_train_state(model, (8, 8, 1), topo, "dpsgd", device="cpu")
    step = make_train_step(model, topo, "dpsgd", fused_sgd=(0.1, 0.0))
    batch = (torch.zeros((2, 4, 8, 8, 1)), torch.zeros((2, 4),
                                                      dtype=torch.int64))
    out = profiling.timed_steps(step, state, [batch] * 5, warmup=2)
    assert out["timer"] == "host" and out["compile_s"] > 0
    assert 0 < out["step_ms_p50"] <= out["step_ms_p95"]
    assert out["step_ms_mean"] > 0 and out["state"].pass_num == 5
    with pytest.raises(AssertionError):
        profiling.timed_steps(step, state, [batch], warmup=1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones((16, 16)) @ torch.ones((16, 16))
    assert (tmp_path / "trace.json").stat().st_size > 0


# --- procwatch -----------------------------------------------------------------


def test_run_deadlined_returns_and_kills():
    out, timed_out, rc = procwatch.run_deadlined(
        [sys.executable, "-c", "print('hi')"], dict(os.environ), 60)
    assert (out.strip(), timed_out, rc) == ("hi", False, 0)
    out, timed_out, rc = procwatch.run_deadlined(
        [sys.executable, "-c", "import time; print('up', flush=True); "
         "time.sleep(60)"], dict(os.environ), 3)
    assert timed_out and rc is None and "up" in (out or "")
    assert procwatch.run_deadlined(["/nonexistent-binary"],
                                   dict(os.environ), 5) == (None, False, None)


def test_probe_device():
    """The staged child finds the card where there is one, the CPU
    elsewhere; `require_gpu` turns a card-less child into 'crashed'."""
    env = dict(os.environ)
    card = torch.cuda.is_available()
    d = procwatch.probe_device_diag(env, 120)
    assert d["verdict"] == "ok" and d["stage"] == "probe_ok"
    assert d["platform"] == ("gpu" if card else "cpu")
    assert d["kind"] == (torch.cuda.get_device_name(0) if card else "cpu")
    d = procwatch.probe_device_diag(env, 120, require_gpu=True)
    if card:
        assert d["verdict"] == "ok"
    else:
        assert d["verdict"] == "crashed" and d["stage"] == "enum_ok"
        assert "no CUDA device" in d["tail"]
        assert procwatch.probe_device(env, 120, require_gpu=True) == (
            "crashed", "cpu")
