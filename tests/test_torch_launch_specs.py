"""The port's abstract inputs (``repro_torch.launch.specs``) against
``repro.launch.specs``, on the CPU: for every architecture and shape,
each input spec's shape and dtype equal the reference's
``ShapeDtypeStruct`` (a stacked cache leaf ``[R, ...]`` as R per-layer
``meta`` tensors), and ``params_spec``'s parameters equal the
reference's leaves through ``convert``'s name map (a stacked leaf as
its rows), in ``param_dtype``."""
import jax
import numpy as np
import pytest

from repro.configs.registry import ARCH_IDS, SHAPES
from repro.configs.registry import get_config as rget
from repro.launch import specs as RSP
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as S
from repro_torch.launch import specs as SP


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    rcfg, cfg = rget(arch), get_config(arch)
    for shape in SHAPES:
        rkind, rargs = RSP.input_specs(rcfg, shape)
        kind, args = SP.input_specs(cfg, shape)
        assert kind == rkind
        assert all(t.is_meta for _, t in dryrun._flat(list(args)))
        if kind != "decode":
            assert set(args[0]) == set(rargs[0])
            for k, v in args[0].items():
                assert (tuple(v.shape), _dt(v)) == \
                    (rargs[0][k].shape, str(rargs[0][k].dtype)), (shape, k)
            continue
        (tok, caches, lengths), (rtok, rcaches, rlengths) = args, rargs
        for mine, ref in ((tok, rtok), (lengths, rlengths)):
            assert (tuple(mine.shape), _dt(mine)) == \
                (ref.shape, str(ref.dtype))
        want = _ref_leaves(rcaches)
        got: dict = {}
        for layer, (prefix, repeat) in zip(caches, S.cache_paths(cfg)):
            for key, t in dryrun._flat(layer):
                path = prefix + "".join(
                    f"['{k}']" for k in key.rstrip(".").split(".") if k)
                shp, dt, n = got.get(path, (tuple(t.shape), _dt(t), 0))
                assert (shp, dt) == (tuple(t.shape), _dt(t))
                got[path] = (shp, dt, n + 1)
        assert {p: ((n,) + shp, dt) for p, (shp, dt, n) in got.items()} \
            == want, shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_spec_equals_the_reference(arch):
    rcfg, cfg = rget(arch), get_config(arch)
    want = _ref_leaves(RSP.params_spec(rcfg))
    model = SP.params_spec(cfg)
    params = dict(model.named_parameters())
    assert all(p.is_meta for p in params.values())
    rows: dict = {}
    for name, (path, repeat) in S.param_paths(cfg, model).items():
        t = params[name]
        if repeat is None:
            assert (tuple(t.shape), _dt(t)) == want[path], name
        else:
            rows.setdefault(path, []).append((tuple(t.shape), _dt(t)))
    for path, layers in rows.items():
        assert len(set(layers)) == 1, path
        shp, dt = layers[0]
        assert ((len(layers),) + shp, dt) == want[path], path
    assert sum(p.numel() for p in params.values()) == sum(
        int(np.prod(s)) for s, _ in want.values())
