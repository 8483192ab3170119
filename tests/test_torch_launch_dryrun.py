"""The port's analytic dry run (``repro_torch.launch.dryrun``,
``probe``, ``hlo``), on the CPU.

* ``model_flops`` of every (architecture x shape) cell equals the
  reference's, computed in a subprocess: importing
  ``repro.launch.dryrun`` forces 512 host devices (its first lines set
  ``XLA_FLAGS``), which would change every later JAX test in this
  worker.
* ``run_cell(..., probe=True)`` on the 16 x 16 mesh is ``OK`` for every
  applicable cell and ``SKIP`` for ``long_500k`` on the full-attention
  architectures, with the record's keys: the collectives counted, and
  the roofline's collective term with them.
* ``hlo.collective_stats`` and ``roofline_terms`` equal the reference's
  on fixed HLO lines: an all-gather, a reduce-scatter, an async
  ``-start`` tuple, an all-reduce, and both replica-group syntaxes; a
  synchronous tuple (XLA's combined all-reduce) counts every element,
  where the reference counts the last, and one of more than five
  elements is read, where the reference misses it.
* The probe's decomposition is exact: at each family's smoke config and
  a small train, prefill and decode shape, P0 + sum_k (Pk - P0) * n_k of
  ``analyze`` equals ``analyze`` of the whole step, FLOPs, bytes and
  collective bytes equal, with the recurrences in their real
  (``probe=False``) form.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.registry import ARCH_IDS, SHAPES
from repro.launch import hlo as RH
from repro_torch.configs.registry import get_config, shape_applicable
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import dryrun, hlo, probe
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)

ROOT = Path(__file__).resolve().parents[1]

_REF_MODEL_FLOPS = """
import json, sys
from repro.configs.registry import ARCH_IDS, SHAPES, get_config
from repro.launch.dryrun import model_flops
print(json.dumps({a: {s: model_flops(get_config(a), s) for s in SHAPES}
                  for a in ARCH_IDS}))
"""


def test_model_flops_equal_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_MODEL_FLOPS], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.splitlines()[-1])
    got = {a: {s: dryrun.model_flops(get_config(a), s) for s in SHAPES}
           for a in ARCH_IDS}
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_cells_are_ok_or_skip(arch):
    for shape in SHAPES:
        rec = dryrun.run_cell(arch, shape, False, probe=True, verbose=False)
        if not shape_applicable(get_config(arch), shape):
            assert rec["status"] == "SKIP", rec
            assert rec["reason"] == \
                "full-attention arch: long_500k needs sub-quadratic"
            continue
        assert rec["status"] == "OK", rec.get("traceback", rec)
        assert rec["flops"] == rec["probe"]["flops"] > 0
        assert rec["bytes"] == rec["probe"]["bytes"] > 0
        assert rec["collective_bytes"] == rec["probe"]["collective_bytes"]
        assert rec["collective_bytes"] > 0
        assert rec["collectives"] and all(
            v["count"] > 0 and v["bytes"] > 0
            for v in rec["collectives"].values())
        assert "launch.partition" in rec["notes"]
        terms = rec["roofline"]
        assert terms["collective_counted"] is True
        assert terms["collective_s"] == \
            rec["collective_bytes"] / (256 * ICI_BW) > 0
        assert terms["bound_s"] == max(terms["compute_s"], terms["memory_s"],
                                       terms["collective_s"])
        assert terms["compute_s"] == rec["flops"] / (256 * PEAK_FLOPS_BF16)
        assert rec["useful_flops_ratio"] == rec["model_flops"] / rec["flops"]
        assert rec["param_bytes_per_device"] > 0
        kind = SHAPES[shape]["kind"]
        assert ("opt_bytes_per_device" in rec) == (kind == "train")
        assert ("cache_bytes_per_device" in rec) == (kind == "decode")


HLO_LINES = "\n".join([
    "  %ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %p), "
    "replica_groups=[16,16]<=[256], dimensions={0}",
    "  %rs = f32[8,128]{1,0} reduce-scatter(f32[128,128]{1,0} %x), "
    "replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add",
    "  %ars = (f32[64]{0}, f32[64]{0}) all-reduce-start(f32[64]{0} %y), "
    "replica_groups={{0,1}}, to_apply=%add",
    "  %ar = s32[2,3]{1,0} all-reduce(s32[2,3]{1,0} %z), "
    "replica_groups=[2,128]<=[256]",
    "  %a2a = bf16[4,8]{1,0} all-to-all(bf16[4,8]{1,0} %w), "
    "replica_groups={{0,1,2,3}}",
    "  %cp = u8[100]{0} collective-permute(u8[100]{0} %v), "
    "source_target_pairs={{0,1}}",
    "  %add = f32[] add(f32[] %a, f32[] %b)",
])


#: synchronous tuples as XLA's combiners write them (f32[8], f32[4] and
#: f32[]: 52 bytes; and six elements with the ``/*index=5*/`` comment)
TUPLE_LINES = "\n".join([
    "  %ar3 = (f32[8]{0}, f32[4]{0}, f32[]) all-reduce(%a, %b, %c), "
    "replica_groups=[2,4]<=[8], to_apply=%add",
    "  %ar6 = (f32[2]{0}, f32[2]{0}, f32[2]{0}, f32[2]{0}, f32[2]{0}, "
    "/*index=5*/f32[2]{0}) all-reduce(%a, %b, %c, %d, %e, /*index=5*/%f), "
    "replica_groups=[2,4]<=[8], to_apply=%add",
])


def test_hlo_stats_and_roofline_equal_the_reference():
    assert hlo.collective_stats(HLO_LINES) == RH.collective_stats(HLO_LINES)
    stats = hlo.collective_stats(HLO_LINES)
    assert stats["all-gather"] == {"count": 1, "bytes": 16 * 4096 * 2 // 16}
    assert stats["reduce-scatter"] == {"count": 1, "bytes": 8 * 128 * 4 * 4}
    assert stats["all-reduce"]["count"] == 2
    assert hlo._DTYPE_BYTES == RH._DTYPE_BYTES
    for args in ((1e15, 2e12, 3e10, 256), (5.0, 1e9, 0.0, 512)):
        kw = dict(peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, ici_bw=ICI_BW)
        assert hlo.roofline_terms(*args, **kw) == \
            RH.roofline_terms(*args, **kw)


#: each family's smoke config: dense, MoE (Kimi-K2: a leading dense
#: layer and a shared expert), RWKV6, RG-LRU with local attention, VLM
FAMILIES = ("yi_6b", "mixtral_8x7b", "kimi_k2_1t_a32b", "rwkv6_7b",
            "recurrentgemma_2b", "qwen2_vl_7b")
#: (kind, batch, sequence) of the small steps
STEPS = (("train", 2, 16), ("prefill", 2, 32), ("decode", 2, 24))


def _unprobed(cfg):
    """``cfg`` with its recurrences in their real (looped) form."""
    upd = {}
    if cfg.rwkv is not None:
        upd["rwkv"] = cfg.rwkv._replace(probe=False)
    if cfg.rglru is not None:
        upd["rglru"] = cfg.rglru._replace(probe=False)
    return dataclasses.replace(cfg, **upd)


def _args(cfg, kind: str, b: int, s: int) -> tuple:
    if kind == "train":
        return (SP.train_batch_spec(cfg, b, s),)
    if kind == "prefill":
        return (SP.prefill_batch_spec(cfg, b, s),)
    return SP.decode_specs(cfg, b, s)


@pytest.mark.parametrize("arch", FAMILIES)
def test_probe_decomposition_equals_the_whole_step(arch):
    cfg = smoke_config(arch)
    mesh = make_production_mesh()
    for kind, b, s in STEPS:
        def cost(c, **kw):
            c = _unprobed(c)
            return probe._lower_cost(c, kind, _args(c, kind, b, s), mesh,
                                     sequence_shard=True, **kw)
        _, per_kind, total = probe.decompose(cfg, s, cost)
        whole = cost(cfg)
        assert sum(k["count"] for k in per_kind.values()) == cfg.n_layers
        for m in probe.METRICS:
            assert total[m] == whole[m], (kind, m, total[m], whole[m])


def test_hlo_stats_count_every_element_of_a_tuple():
    """Where the reference's scan counts a combined all-reduce by its last
    element (4 bytes) and misses one of six, the port's counts 52 + 48."""
    ref = RH.collective_stats(TUPLE_LINES)["all-reduce"]
    assert ref == {"count": 1, "bytes": 4}
    assert hlo.collective_stats(TUPLE_LINES)["all-reduce"] == \
        {"count": 2, "bytes": 52 + 48}
    events = [("all-gather", 64, 4), ("reduce-scatter", 8, 2),
              ("all-to-all", 16, 4)]
    st = hlo.stats_from_events(events)
    assert st["all-gather"] == {"count": 1, "bytes": 16}
    assert st["reduce-scatter"] == {"count": 1, "bytes": 16}
    assert st["total_bytes"] == 16 + 16 + 16
