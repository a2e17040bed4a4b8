"""`chip_smoke.py`'s limits on the bfloat16 flash outputs, on the CPU.

On the card the bfloat16 kernels are held element by element (atol =
rtol = 5e-2) and as a whole (||got - want|| / ||want|| <=
`BF16_REL_NORM`). At the main shapes (T = 1024, q, k, v, dO ~ N(0, 1))
a dQ element is about N(0, e / n) over its row's n keys, so 5e-2 is the
size of a typical element: a fault that shrinks dQ a little everywhere
passes it. Here dQ's plain version stands in for the kernel: with ds
rounded to bfloat16 before `ds k`, as the wgmma form does, it must pass
both limits with room to spare; with a uniform 3% loss it must pass the
element-wise limit and fail the norm; with the last query block's rows
missing one K tile it must fail the norm.

Also `chip_smoke._same_records`, the one record comparator of every
leg: on named keys, and on every key but a skip set with the block-end
riders allowed to be absent, a NaN equal to a NaN.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from eventgrad_tpu_torch.ops import attention as fa

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ELEM = dict(atol=5e-2, rtol=5e-2)


def _dq_case(d, seed=0, b=1, t=1024, h=2):
    """bf16 q, k, v, dO at a main shape's T and D; dQ's plain version
    (float32 arithmetic, bf16 out) and `ds` of its backward."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, t, h, d))
                                    .astype(np.float32)).bfloat16()
                   for _ in range(4))
    out, lse = fa.lse_reference(q, k, v, None, True, 1)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse.transpose(1, 2).contiguous(), delta, None, True,
            1)
    _, ds = fa._bwd_terms(*args)
    return fa.dq_reference(*args), ds, k


def _ds_k(ds, k):
    """dQ = ds k with ds rounded to bf16 first, as the wgmma form does."""
    return torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(),
                        k.float()).bfloat16()


def test_rel_norm_err_reads_the_whole_tensor():
    want = torch.tensor([3.0, 4.0])
    assert smoke.rel_norm_err(want + torch.tensor([0.3, 0.4]), want) == \
        pytest.approx(0.1)
    zero = torch.zeros(3)
    assert smoke.rel_norm_err(zero, zero) == 0.0
    assert smoke.rel_norm_err(zero + 1, zero) == float("inf")


@pytest.mark.parametrize("d", [64, 256])
def test_bf16_rounding_of_ds_holds_both_limits(d):
    want, ds, k = _dq_case(d)
    got = _ds_k(ds, k)
    smoke.within(got, want, what="dq", rel_norm=smoke.BF16_REL_NORM, **ELEM)
    assert smoke.rel_norm_err(got, want) < smoke.BF16_REL_NORM / 2


@pytest.mark.parametrize("d", [64, 256])
def test_a_uniform_loss_passes_the_elementwise_limit_not_the_norm(d):
    want, ds, k = _dq_case(d)
    got = _ds_k(ds * 0.97, k)
    smoke.within(got, want, what="dq", **ELEM)
    with pytest.raises(smoke.SmokeError, match="relative norm error .* "
                       "outside"):
        smoke.within(got, want, what="dq", rel_norm=smoke.BF16_REL_NORM,
                     **ELEM)


@pytest.mark.parametrize("d", [64, 256])
def test_a_lost_key_tile_fails_the_norm(d):
    want, ds, k = _dq_case(d)
    ds = ds.clone()
    ds[:, :, -64:, 512:576] = 0  # the last 64 rows miss keys 512-575
    got = _ds_k(ds, k)
    assert smoke.rel_norm_err(got, want) > smoke.BF16_REL_NORM
    with pytest.raises(smoke.SmokeError, match="relative norm error"):
        smoke.within(got, want, what="dq", rel_norm=smoke.BF16_REL_NORM,
                     **ELEM)


def test_same_records_on_named_and_on_all_keys():
    nan = float("nan")
    a = [{"epoch": 1, "loss": nan, "wall_s": 1.0, "dispatch_block": 0},
         {"epoch": 2, "loss": 0.5, "wall_s": 2.0, "dispatch_block": 0,
          "test_accuracy": 10.0}]
    b = [{"epoch": 1, "loss": nan, "wall_s": 3.0, "dispatch_block": 0},
         {"epoch": 2, "loss": 0.5, "wall_s": 4.0, "dispatch_block": 1,
          "test_accuracy": 10.0}]
    smoke._same_records(a, b, "named", keys=("loss",))
    skip = ("wall_s", "dispatch_block")
    smoke._same_records(a, b, "all", keys=None, skip=skip)
    # a block-end rider may be absent from the second run's record
    smoke._same_records(a, [b[0], {k: v for k, v in b[1].items()
                                   if k != "test_accuracy"}], "rider",
                        keys=None, skip=skip)
    with pytest.raises(smoke.SmokeError, match="wall_s"):
        smoke._same_records(a, b, "timing", keys=None)
    for k, v in (("loss", 0.25), ("test_accuracy", 11.0), ("extra", 1)):
        with pytest.raises(smoke.SmokeError, match=k):
            smoke._same_records(a, [b[0], {**b[1], k: v}], k, keys=None,
                                skip=skip)


def test_finish_children_fails_fast_and_stops_the_rest(tmp_path):
    """`chip_smoke._finish_children`: a child that exits non-zero fails the
    wait at once (its group's peers would wait for it until the timeout)
    and the others are killed; children that all exit 0 pass."""
    import subprocess
    import sys
    import time

    def child(code, name):
        out = tmp_path / name
        with open(out, "w") as fh:
            return subprocess.Popen([sys.executable, "-c", code], stdout=fh,
                                    stderr=subprocess.STDOUT), out

    sleeper = child("import time; time.sleep(60)", "sleeper.out")
    failing = child("print('bad'); raise SystemExit(3)", "failing.out")
    t = time.perf_counter()
    with pytest.raises(smoke.SmokeError, match="a child exited 3:\nbad"):
        smoke._finish_children([sleeper, failing], "group")
    assert time.perf_counter() - t < 30
    assert sleeper[0].poll() is not None
    smoke._finish_children([child("pass", f"ok{i}.out") for i in range(2)],
                           "group")
