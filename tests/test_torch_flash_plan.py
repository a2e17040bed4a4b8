"""The flash kernels' forms and shared-memory plan, on the CPU.

`eventgrad_tpu_torch/ops/flash_plan.py` mirrors the C dispatcher
(`csrc/flash_base.cuh`, `flash_form`): which form a forward, dQ or dK/dV
launch takes, chosen by shape before the launch, and what shared memory
each instantiation asks for. `chip_smoke.py` holds the mirror against the
C side on the card; here the rule itself is pinned on the shapes the
port runs: the transformer legs' strided q/k/v views, the misaligned
rows of the small cases (`lead`), ragged head widths.
"""

import contextlib

import pytest
import torch

from eventgrad_tpu_torch import ops
from eventgrad_tpu_torch.ops import attention as fa
from eventgrad_tpu_torch.ops import build, flash_plan

#: the transformer legs' flash shapes (chip_smoke.py): B, T, H, D
MAIN = [(32, 1024, 8, 64), (32, 1024, 16, 128), (32, 1024, 8, 256)]


def _fused_views(shape, dtype):
    """q, k, v as the model hands them over: strided views of one fused
    projection `[B, T, 3H, D]` (a small B and T keep the strides' form)."""
    b, t, h, d = shape
    qkv = torch.empty((2, 8, 3 * h, d), dtype=dtype)
    return qkv.split(h, dim=2)


def _lead_views(d, dtype, lead=1):
    """The small cases' rows offset by `lead` elements: only 2-byte
    (bf16) or 4-byte (f32) aligned."""
    return [torch.empty((2, 16, 2, lead + d), dtype=dtype)[..., lead:]
            for _ in range(3)]


@pytest.mark.parametrize("shape", MAIN, ids=lambda s: f"D{s[3]}")
def test_main_shapes_take_the_new_forms(shape):
    q, k, v = _fused_views(shape, torch.bfloat16)
    do = torch.empty(q.shape, dtype=torch.bfloat16)
    assert flash_plan.tensor_form(q, k, v) == "wgmma"
    assert flash_plan.tensor_form(q, k, v, do) == "wgmma"
    q, k, v = _fused_views(shape, torch.float32)
    want = "whole" if shape[3] == 256 else "mma"
    assert flash_plan.tensor_form(q, k, v) == want
    assert flash_plan.tensor_form(q, k, v, q) == want


@pytest.mark.parametrize("shape", MAIN, ids=lambda s: f"D{s[3]}")
def test_dq_takes_the_form_of_its_four_tensors(shape):
    """dQ reads q, k, v and dO, as dK/dV does, so it takes the same rule:
    wgmma in bf16, whole at f32 D 256, mma at f32 D 64 and 128."""
    for dtype, want in ((torch.bfloat16, "wgmma"),
                        (torch.float32,
                         "whole" if shape[3] == 256 else "mma")):
        q, k, v = _fused_views(shape, dtype)
        do = torch.empty(q.shape, dtype=dtype)
        assert flash_plan.tensor_form(q, k, v, do) == want
    # a misaligned dO alone keeps bf16 dQ on the mma form
    q, k, v = _fused_views(shape, torch.bfloat16)
    lead = _lead_views(shape[3], torch.bfloat16)[0]
    assert flash_plan.tensor_form(q, k, v, lead) == "mma"
    assert flash_plan.tensor_form(*_lead_views(shape[3], torch.bfloat16),
                                  do) == "mma"


@pytest.mark.parametrize("d", [64, 128, 256])
def test_misaligned_rows_keep_the_mma_form_in_bfloat16(d):
    q, k, v = _lead_views(d, torch.bfloat16)
    assert q.data_ptr() % 16 and (q.stride(1) * 2) % 16
    assert flash_plan.tensor_form(q, k, v) == "mma"
    # one misaligned tensor is enough, dO included
    good = _fused_views((2, 8, 2, d), torch.bfloat16)
    assert flash_plan.tensor_form(*good) == "wgmma"
    assert flash_plan.tensor_form(*good, q) == "mma"
    # float32 at 256 takes the whole form whatever the alignment
    f = _lead_views(d, torch.float32)
    assert flash_plan.tensor_form(*f) == ("whole" if d == 256 else "mma")


@pytest.mark.parametrize("d", [16, 24, 32, 80, 96, 160, 192, 320, 512])
def test_ragged_head_widths_keep_the_mma_form(d):
    for dtype in (torch.bfloat16, torch.float32):
        assert flash_plan.tensor_form(*_fused_views((2, 8, 2, d), dtype)) \
            == "mma"


@pytest.mark.parametrize("ptrs,strides,form", [
    ((0, 16, 32), (16,) * 9, "wgmma"),
    ((0, 16, 40), (16,) * 9, "mma"),     # one pointer 8 bytes off
    ((0, 16, 32), (16,) * 8 + (4,), "mma"),   # a stride of 8 bytes
    ((0, 16, 32), (16,) * 8 + (0,), "mma"),   # a broadcast (zero) stride
    ((0, 16, 32), (16,) * 8 + (-8,), "mma"),  # a negative stride
])
def test_dispatch_rule_on_raw_pointers_and_strides(ptrs, strides, form):
    assert flash_plan.flash_form("bfloat16", 128, ptrs, strides) == form
    # the rule only reads alignment for bfloat16
    assert flash_plan.flash_form("float32", 128, ptrs, strides) == "mma"


@pytest.mark.parametrize("inst", flash_plan.instantiations(),
                         ids=lambda i: f"{i[0]}-{i[1]}-{i[2]}-{i[3]}"
                                       f"{'-wide' if i[4] else ''}")
def test_every_instantiation_fits_shared_memory(inst):
    assert 0 < flash_plan.smem_bytes(*inst) <= flash_plan.SMEM_MAX == 232_448


@pytest.mark.parametrize("kernel,form,d,want", [
    # wgmma: 1 KB of alignment slack, q [128, D] (forward) or k, v
    # [64, D] (dK/dV), the stages (4 at D 64, 3 at 128, 2 at 256) of two
    # [64, D] bf16 tiles, dK/dV's 16 KB p exchange, 8 bytes a barrier
    # (forward: q, and three a stage; dK/dV: k and v, and two a stage)
    ("flash_fwd", "wgmma", 64, 1024 + 16384 + 4 * 16384 + 8 * 13),
    ("flash_fwd", "wgmma", 128, 1024 + 32768 + 3 * 32768 + 8 * 10),
    ("flash_fwd", "wgmma", 256, 1024 + 65536 + 2 * 65536 + 8 * 7),
    ("flash_dkv", "wgmma", 64, 1024 + 16384 + 4 * 16384 + 16384 + 8 * 9),
    ("flash_dkv", "wgmma", 128, 1024 + 32768 + 3 * 32768 + 16384 + 8 * 7),
    ("flash_dkv", "wgmma", 256, 1024 + 65536 + 2 * 65536 + 16384 + 8 * 5),
    # dQ: q and dO resident ([128, D] at D 64 and 128, where each
    # warpgroup runs all three products for its 64 rows; [64, D] and the
    # p exchange at 256, where the warpgroups split the products), the
    # stages of k and v [64, D]; barriers q/dO, and full, empty a stage
    ("flash_dq", "wgmma", 64, 1024 + 32768 + 4 * 16384 + 8 * 9),
    ("flash_dq", "wgmma", 128, 1024 + 65536 + 3 * 32768 + 8 * 7),
    ("flash_dq", "wgmma", 256, 1024 + 65536 + 2 * 65536 + 16384 + 8 * 5),
    # whole: [rows][260] float32 tiles, [rows][68] p tiles
    ("flash_fwd", "whole", 256, 3 * 64 * 1040 + 64 * 272 + 512),
    ("flash_dkv", "whole", 256, 2 * 32 * 1040 + 2 * 64 * 1040
     + 2 * 32 * 272 + 512),
    # dQ: q, dO [64][260], k, v [32][260], the p / ds tile [64][36]
    ("flash_dq", "whole", 256, 2 * 64 * 1040 + 2 * 32 * 1040 + 64 * 144),
])
def test_new_forms_shared_memory_by_hand(kernel, form, d, want):
    elem = 2 if form == "wgmma" else 4
    assert flash_plan.smem_bytes(kernel, form, elem, d) == want


def test_the_forms_cover_every_compiled_instantiation():
    insts = flash_plan.instantiations()
    assert len(insts) == len(set(insts)) == 9 + 3 + 24
    assert {i[1] for i in insts} == set(flash_plan.FORMS)


def test_the_new_dq_instantiations_are_compiled():
    insts = set(flash_plan.instantiations())
    for d in flash_plan.WGMMA_D:
        assert ("flash_dq", "wgmma", 2, d, False) in insts
    assert ("flash_dq", "whole", 4, 256, False) in insts


def test_form_counters_clear_with_the_launch_counters():
    for fn in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv):
        fn.forms["mma"] += 1
    # dQ at the d256 bf16 main shape: the form the rule names
    q, k, v = _fused_views(MAIN[2], torch.bfloat16)
    form = flash_plan.tensor_form(q, k, v, torch.empty(q.shape,
                                                       dtype=q.dtype))
    fa.flash_dq.forms[form] += 1
    assert fa.form_counts()["flash_dq"][form] >= 1
    ops.reset_launch_counts()
    assert all(n == 0 for forms in fa.form_counts().values()
               for n in forms.values())
    assert set(fa.form_counts()["flash_fwd"]) == set(flash_plan.FORMS)


class _NoLibrary:
    """Stands in for the kernel library: every entry point returns 0."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 256, "whole"),
    (torch.float32, 64, "mma"), (torch.bfloat16, 24, "mma"),
])
def test_dq_wrapper_counts_its_launches_by_form(monkeypatch, dtype, d, want):
    """The CUDA implementation of `eg::flash_dq` counts each launch under
    the form the rule names for its four tensors (the launch itself
    stubbed: there is no card here), and `ops.reset_launch_counts()`
    clears the count."""
    monkeypatch.setattr(build, "library", lambda: _NoLibrary())
    monkeypatch.setattr(build, "launch", lambda what, fn, *args: fn(*args))
    monkeypatch.setattr(build, "stream_of", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    ops.reset_launch_counts()
    q, k, v = _fused_views((2, 8, 2, d), dtype)
    do = torch.empty(q.shape, dtype=dtype)
    lse = torch.zeros((2, 2, 8))
    for n in (1, 2):
        fa._flash_dq_cuda(q, k, v, do, lse, lse, None, True, 1)
        assert fa.form_counts()["flash_dq"] == {
            f: (n if f == want else 0) for f in flash_plan.FORMS}
    assert fa.flash_dq.launches == 2
    ops.reset_launch_counts()
    assert set(fa.form_counts()["flash_dq"].values()) == {0}
    assert fa.flash_dq.launches == 0
