"""The recurrences' probe mode (``RWKVConfig(probe=True)``,
``RGLRUConfig(probe=True)``: the reference's loop-free, FLOP-isomorphic
cost-analysis stand-ins, not valid models) against the reference's probe
branch, on the CPU: RWKV6's and RecurrentGemma's smoke configs in
float32, the reference's weights carried over by ``convert``, the
forward's logits within 1e-5 absolute and relative, and each probe
layer's state too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as rsmoke
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import transformer as T


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite's parallel workers would otherwise oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)


def _probed(cfg, dtype):
    upd = {"compute_dtype": dtype}
    if cfg.rwkv is not None:
        upd["rwkv"] = cfg.rwkv._replace(probe=True)
    if cfg.rglru is not None:
        upd["rglru"] = cfg.rglru._replace(probe=True)
    return dataclasses.replace(cfg, **upd)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "recurrentgemma_2b"])
def test_probe_layers_equal_the_reference(arch):
    rcfg = _probed(rsmoke(arch), jnp.float32)
    cfg = _probed(smoke_config(arch), torch.float32)
    params = jax.device_get(JT.init_params(rcfg, jax.random.PRNGKey(3)))
    model = convert.model_from_numpy(cfg, params, "cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 16)) \
        .astype(np.int32)
    want, _, wcaches = JT.forward(rcfg, params,
                                  {"tokens": jnp.asarray(tokens)},
                                  want_caches=True)
    with torch.no_grad():
        got, _, gcaches = T.forward(cfg, model,
                                    {"tokens": torch.from_numpy(tokens)},
                                    want_caches=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the probe layers' states, against the reference's stacked caches
    wlayers = convert.caches_to_numpy(cfg, [
        {k: v for k, v in c.items()} for c in gcaches])
    for stack_got, stack_want in zip(wlayers, wcaches):
        for pos, state in stack_got.items():
            if "attn" in state:
                continue
            flat_g = jax.tree_util.tree_leaves(state)
            flat_w = jax.tree_util.tree_leaves(stack_want[pos])
            assert len(flat_g) == len(flat_w)
            for g, w in zip(flat_g, flat_w):
                np.testing.assert_allclose(g, np.asarray(w), **TOL)
