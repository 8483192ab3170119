"""The port's partition rules (``repro_torch.launch.sharding``) against
``repro.launch.sharding`` on the production meshes, on the CPU.

The reference's rules run on ``jax.sharding.AbstractMesh`` (no devices
needed), so every spec and every per-device byte count of the dry run
is held against it exactly, for all ten architectures on the 16 x 16
and 2 x 16 x 16 meshes:

* each parameter's spec equals the reference's spec of its leaf
  through ``convert``'s name map (a stacked leaf's spec less its
  leading ``None``); likewise each decode cache leaf at ``decode_32k``,
  each shape's batch, ``moe_axes`` and ``moe_compute_axes``;
* ``dryrun.device_bytes`` equals the reference dry run's
  ``tree_device_bytes`` arithmetic (``NamedSharding.shard_shape`` of
  each leaf times its item size) for params, AdamW state and caches in
  every (architecture x shape x mesh) cell;
* ``mesh.dp_axes``, ``model_axis`` and ``dp_size`` equal on both
  meshes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro import optim as ropt
from repro.configs.registry import ARCH_IDS, SHAPES
from repro.configs.registry import get_config as rget
from repro.launch import mesh as RM
from repro.launch import sharding as RS
from repro.launch import specs as RSP
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.launch import specs as SP

MESHES = {"16x16": False, "2x16x16": True}


def _meshes(multi_pod: bool):
    ref = AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else AbstractMesh((16, 16), ("data", "model"))
    return ref, M.make_production_mesh(multi_pod=multi_pod)


def _leaves(specs_tree, shapes_tree) -> dict:
    """keystr -> (spec tuple, shard shape, item size) of the reference."""
    return {jax.tree_util.keystr(p): (tuple(s.spec), s.shard_shape(l.shape),
                                      l.dtype.itemsize)
            for (p, s), l in zip(
                jax.tree_util.tree_leaves_with_path(
                    specs_tree, is_leaf=lambda x: isinstance(
                        x, NamedSharding)),
                jax.tree_util.tree_leaves(shapes_tree))}


def _bytes(leaves: dict) -> int:
    return sum(int(np.prod(shard)) * isz for _, shard, isz in leaves.values())


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_helpers_equal_the_reference(mesh_name):
    ref, mine = _meshes(MESHES[mesh_name])
    assert M.axis_sizes(mine) == dict(ref.shape)
    assert M.dp_axes(mine) == RM.dp_axes(ref)
    assert M.model_axis(mine) == RM.model_axis(ref)
    assert M.dp_size(mine) == RM.dp_size(ref)
    assert mine.size == ref.size


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_device_bytes_equal_the_reference(arch):
    rcfg, cfg = rget(arch), get_config(arch)
    rspec = RSP.params_spec(rcfg)
    model = SP.params_spec(cfg)
    for multi_pod in MESHES.values():
        ref, mine = _meshes(multi_pod)
        if cfg.moe is not None:
            assert S.moe_axes(cfg, mine) == RS.moe_axes(rcfg, ref)
            assert S.moe_compute_axes(cfg, mine) == \
                RS.moe_compute_axes(rcfg, ref)
        # parameters, leaf for leaf through convert's name map
        rleaves = _leaves(RS.param_shardings(rcfg, ref, rspec), rspec)
        psh = S.param_shardings(cfg, mine, model)
        paths = S.param_paths(cfg, model)
        assert {p for p, _ in paths.values()} == set(rleaves)
        for name, (path, repeat) in paths.items():
            want = rleaves[path][0]
            if repeat is not None:
                assert want[0] is None, (path, want)
                want = want[1:]
            assert psh[name] == want, (name, path, psh[name], want)
        # AdamW state (moments in param_dtype's precision, as dryrun's
        # _opt_spec sets them)
        opt_cfg = ropt.AdamWConfig(
            moment_dtype=jnp.bfloat16 if rcfg.param_dtype == jnp.bfloat16
            else jnp.float32)
        ospec = jax.eval_shape(lambda p: ropt.init(p, opt_cfg), rspec)
        opt_bytes = _bytes(_leaves(
            RS.opt_shardings(RS.param_shardings(rcfg, ref, rspec)), ospec))
        for shape in SHAPES:
            kind, args = RSP.input_specs(rcfg, shape)
            got = dryrun.device_bytes(cfg, shape, mine)
            want = {"param_bytes_per_device": _bytes(rleaves)}
            if kind == "train":
                want["opt_bytes_per_device"] = opt_bytes
            if kind == "decode":
                _, caches, _ = args
                cleaves = _leaves(RS.cache_shardings(rcfg, ref, caches),
                                  caches)
                want["cache_bytes_per_device"] = _bytes(cleaves)
            assert got == want, (shape, multi_pod, got, want)
            # the batch specs of every shape
            _, margs = SP.input_specs(cfg, shape)
            batch = args[0] if kind != "decode" else {
                "tokens": args[0], "lengths": args[2]}
            mbatch = margs[0] if kind != "decode" else {
                "tokens": margs[0], "lengths": margs[2]}
            rb = RS.batch_shardings(rcfg, ref, batch)
            mb = S.batch_shardings(cfg, mine, mbatch)
            assert mb == {k: tuple(v.spec) for k, v in rb.items()}, shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch):
    rcfg, cfg = rget(arch), get_config(arch)
    for multi_pod in MESHES.values():
        ref, mine = _meshes(multi_pod)
        _, caches, _ = RSP.decode_specs(rcfg, 128, SHAPES["decode_32k"]
                                        ["seq_len"])
        rleaves = _leaves(RS.cache_shardings(rcfg, ref, caches), caches)
        _, mcaches, _ = SP.decode_specs(cfg, 128,
                                        SHAPES["decode_32k"]["seq_len"])
        msh = S.cache_shardings(cfg, mine, mcaches)
        seen = set()
        for layer, (prefix, repeat) in zip(msh, S.cache_paths(cfg)):
            for key, spec in dryrun._flat(layer):
                path = prefix + "".join(
                    f"['{k}']" for k in key.rstrip(".").split(".") if k)
                want = rleaves[path][0]
                assert want[0] is None and spec == want[1:], \
                    (path, spec, want)
                seen.add(path)
        assert seen == set(rleaves)
