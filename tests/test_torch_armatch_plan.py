"""The ``armatch`` wrapper's choice of kernel instance and its launch
accounting, on the CPU: :func:`ops.plan` at the AR path's shapes and on
both sides of the narrow instance's limit, the launcher called once a
call with the planned instance (through a stand-in for the compiled
library), and the limits the wrapper and ``csrc/armatch.cu`` share."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import checks
from repro_torch.kernels.armatch import armatch, armatch_ref, ops

CU = Path(ops.__file__).resolve().parents[1] / "csrc" / "armatch.cu"


@pytest.mark.parametrize("m,n,want", [
    (65536, 1024, "wide"),      # the AR step's notify match
    (1 << 20, 1, "narrow"),     # a query against the 2^20-row shard
    (64, 1, "narrow"),          # the registry's lookup
])
def test_plan_at_the_path_shapes(m, n, want):
    assert ops.plan(m, n) == want


@pytest.mark.parametrize("m,n,want", [
    (1000, ops.NARROW_MAX_N, "narrow"), (1000, ops.NARROW_MAX_N + 1, "wide"),
    (1, 1, "narrow"), (1, ops.NARROW_MAX_N + 1, "wide"),
])
def test_plan_either_side_of_the_limit(m, n, want):
    assert ops.plan(m, n) == want


class _FakeLib:
    """Stands in for the compiled library: records each launch."""

    def __init__(self):
        self.calls = []

    def armatch_i32(self, data, ints, out, m, n, instance, sms, stream):
        self.calls.append((m, n, instance, sms))
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(ops, "_lib", lambda: lib)
    monkeypatch.setattr(ops, "_sms", lambda index: 132)
    monkeypatch.setattr(ops, "_stream", lambda device: 0)
    monkeypatch.setattr(armatch, "launches", 0)
    monkeypatch.setattr(armatch, "simple_launches", 0)
    return lib


@pytest.mark.parametrize("m,n,instance,code", [
    (65536, 1024, None, 2), (64, 1, None, 1), (300, 40, "simple", 0),
    (300, 8, "wide", 2),
])
def test_launch_counts_one_a_call(fake, m, n, instance, code):
    data = torch.zeros((m, 128), dtype=torch.int32)
    ints = torch.zeros((n, 128), dtype=torch.int32)
    for i in range(1, 3):
        out = ops._launch(data, ints, instance)
        assert out.shape == (m, n) and out.dtype == torch.int32
        assert armatch.launches == i
        assert armatch.simple_launches == (i if instance == "simple" else 0)
    assert fake.calls == [(m, n, code, 132)] * 2


def test_launch_skips_an_empty_call(fake):
    out = ops._launch(torch.zeros((0, 128), dtype=torch.int32),
                      torch.zeros((5, 128), dtype=torch.int32), None)
    assert out.shape == (0, 5) and fake.calls == [] and armatch.launches == 0


def test_aligned_copies_only_a_view_off_16_bytes():
    flat = torch.arange(3 * 128 + 1, dtype=torch.int32)
    off = flat[1:].view(3, 128)
    assert off.data_ptr() % 16 == 4
    fixed = ops._aligned(off)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, off)
    on = flat[:256].view(2, 128)
    assert ops._aligned(on).data_ptr() == on.data_ptr()


@pytest.mark.parametrize("instance", ["fast", "narrow"])
def test_wrapper_rejects_an_instance_it_cannot_run(instance):
    ints = torch.zeros((ops.NARROW_MAX_N + 1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="instance"):
        armatch(torch.zeros((4, 128), dtype=torch.int32), ints,
                instance=instance)


@pytest.mark.parametrize("instance", ["simple", "narrow", "wide"])
def test_cpu_takes_the_plain_version_whatever_the_instance(instance):
    rng = np.random.default_rng(8)
    data = torch.from_numpy(checks.random_profiles(rng, 50))
    ints = torch.from_numpy(checks.random_profiles(rng, 6, max_slots=3))
    before = armatch.launches
    got = armatch(data, ints, instance=instance)
    assert armatch.launches == before
    assert torch.equal(got, armatch_ref(data, ints))


def test_kernel_source_agrees_with_the_wrapper():
    """Every instance is a ``__global__`` named ``armatch_kernel*`` (the
    name ``chip_smoke.py`` counts in a trace), and the narrow limit and
    the instance codes are the wrapper's."""
    src = CU.read_text()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s+)?(\w+)", src)
    assert sorted(kernels) == ["armatch_kernel_narrow",
                               "armatch_kernel_simple", "armatch_kernel_wide"]
    limit = re.search(r"constexpr int kNarrowMaxN = (\d+);", src)
    assert int(limit.group(1)) == ops.NARROW_MAX_N
    codes = re.search(r"enum Instance \{ kSimple = (\d), kNarrow = (\d), "
                      r"kWide = (\d) \};", src)
    assert tuple(map(int, codes.groups())) == (
        ops.INSTANCES["simple"], ops.INSTANCES["narrow"], ops.INSTANCES["wide"])


def test_eight_slot_inputs_use_every_slot_and_match_themselves():
    """The card check's all-slots case: every nonzero row uses 8 slots on
    both sides, and the copied interests match their own data rows."""
    data, ints = checks._armatch_inputs(np.random.default_rng(1), 300, 8,
                                        "eight")
    used = data.reshape(300, 8, 16)[..., 9] > 0
    assert (used.all(1) | ~used.any(1)).all() and used.all(1).mean() > 0.9
    out = armatch_ref(torch.from_numpy(data), torch.from_numpy(ints))
    assert 0 < int(out.sum()) < out.numel()
