"""The port's dry run on the 2 x 16 x 16 mesh without probes (the
reference's only multi-pod mode) for mixtral_8x7b: every shape's
``run_cell`` analyses the whole deploy step (8 microbatches for
training) on ``meta`` tensors and is ``OK`` (``SKIP`` for a
full-attention architecture at ``long_500k``); the work counted
agrees with the model's own FLOPs, and the collectives are counted
(the roofline's collective term with them): training's gradients are
all-reduced over the "pod" axis with the data axis, the dp axes the
batch is sharded over on this mesh.  One architecture a file: a
full-depth step takes tens of seconds to count."""
import pytest

from repro.configs.registry import SHAPES
from repro_torch.configs.registry import get_config, shape_applicable
from repro_torch.launch import dryrun

ARCH = "mixtral_8x7b"


@pytest.mark.parametrize("shape", list(SHAPES))
def test_multi_pod_cell_is_ok_or_skip(shape):
    rec = dryrun.run_cell(ARCH, shape, True, verbose=False)
    if not shape_applicable(get_config(ARCH), shape):
        assert rec["status"] == "SKIP", rec
        return
    assert rec["status"] == "OK", rec.get("traceback", rec)
    assert rec["mesh"] == "2x16x16" and "probe" not in rec
    assert rec["collective_bytes"] > 0
    assert rec["collectives"] and all(v["count"] > 0 and v["bytes"] > 0
               for v in rec["collectives"].values())
    assert rec["roofline"]["collective_counted"] is True
    assert rec["roofline"]["collective_s"] > 0
    if SHAPES[shape]["kind"] == "train":
        assert any({"pod", "data"} <= set(g)
                   for g in rec["collective_groups"]["all-reduce"]), \
            rec["collective_groups"]
    # the whole program does at least the model's FLOPs (remat and the
    # attention scores add more)
    assert 0.0 < rec["useful_flops_ratio"] <= 1.0, rec
