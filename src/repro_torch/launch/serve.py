"""Serving entry point: batched decode behind the AR pub/sub front door.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        [--smoke] [--requests 16] [--prompt-len 16] [--tokens 32] \
        [--device cpu]

Port of ``repro.launch.serve``.  The decode step is registered in the
serverless ``FunctionRegistry`` under a function profile
(``decode:<name>``, profile ``serve`` + the model's name); ``run``
resolves it by associative matching with the ``serve`` interest (the
``armatch`` kernel on the card) and captures it ahead of time there,
as the reference AOT-compiles it: the decode loop replays that CUDA
graph every step (``runtime.capture``; on the CPU the step runs
eagerly).  It prefills each request by decoding its prompt
teacher-forced, then generates greedily (argmax).  Any of the
ten configs serves: attention layers keep ring KV caches and attend
through ``decode_attn``, RWKV6 and RG-LRU layers carry their recurrent
states.  The model is the port's seeded random init unless the caller
hands one in; given a host mesh, its parameters are laid out by
``launch.sharding``'s rules (one rank: every shard is the whole tensor,
so nothing moves) and the registry keys the captured step on the mesh.
Over N > 1 data ranks (one a process, ``launch.mesh.spawn``) the
requests are split by rank, as ``cache_shardings`` lays the decode
batch over "data": every replica takes rank 0's parameters (broadcast
once), rank r serves rows ``[r B / N, (r + 1) B / N)`` of the prompts
with caches of B / N rows through its own registry and captured step,
and one all-gather gives every rank all B rows of ids at the end.  An
MoE layer plans over all B rows, as one process serving them would
(one all-gather of its expert ids a step, inside the captured step:
``steps.build_serve_step(split_requests=True)``).  A B that N does not
divide replicates: every rank serves all of it, and plans on its own.
Runs on the CUDA card unless the caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.core import profiles as P
from repro_torch.core.serverless import FunctionRegistry
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (all_gather, axis_sizes,
                                     broadcast_params, data_group, data_rank,
                                     dp_size, make_host_mesh)
from repro_torch.models import transformer as T


class ServeResult(NamedTuple):
    tokens: np.ndarray          # [requests, tokens] generated ids (every
                                # rank's rows, gathered)
    secs: list                  # wall seconds of each decode step
    launches: int               # decode_attn kernel launches in the loop
                                # (0 for a model without attention),
                                # replays counted by the capture
    finite: bool                # every step's logits were finite
    logits: torch.Tensor        # [requests, vocab] after the last step
    caches: list                # the per-layer caches / states at the end
    lengths: torch.Tensor       # [requests] cache fill at the end
    model: T.Transformer
    resolved: str               # the registry entry that served
    aot_cached: int             # the registry's captured steps
    step: Callable              # the captured decode step
    rows: slice                 # the requests this rank served (logits,
                                # caches and lengths hold these rows)


def prompts_for(cfg, requests: int, prompt_len: int,
                seed: int = 0) -> np.ndarray:
    """[requests, prompt_len] int32 prompt ids, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (requests, prompt_len)).astype(np.int32)


def request_rows(requests: int, mesh) -> slice:
    """The rows of ``requests`` this rank serves on ``mesh``: its
    ``1 / N`` of them over N data ranks, all of them where N does not
    divide them (or there is one rank)."""
    n = 1 if data_group(mesh) is None else dp_size(mesh)
    if requests % n:
        return slice(0, requests)
    per = requests // n
    r = data_rank(mesh)
    return slice(r * per, (r + 1) * per)


def run(cfg, requests: int, prompt_len: int, tokens: int, *,
        device: str | torch.device | None = None, seed: int = 0,
        model: T.Transformer | None = None, mesh=None,
        prompts: np.ndarray | None = None) -> ServeResult:
    """Serve ``requests`` prompts of ``prompt_len`` ids (seeded, or
    ``prompts [requests, prompt_len]``) and generate ``tokens`` ids
    each, on the host ``mesh`` if given (over N > 1 data ranks, this
    rank's :func:`request_rows`).  Every step is timed with a
    synchronize on the card; nothing is read back inside the loop."""
    dev = resolve_device(device)
    if model is None:
        model = T.init_params(cfg, seed=seed, device=dev)
    if mesh is not None:
        model = shd.place(model, shd.param_shardings(cfg, mesh, model), mesh)
    group = data_group(mesh)
    if group is not None:           # the replicas serve rank 0's weights
        broadcast_params(model, group)
    rows = request_rows(requests, mesh)
    b, max_len = rows.stop - rows.start, prompt_len + tokens

    # serverless front door: register the decode topology under a profile
    registry = FunctionRegistry(dev)
    registry.store_function(f"decode:{cfg.name}", P.profile("serve", cfg.name),
                            steps_mod.build_serve_step(
                                cfg, mesh=mesh, split_requests=b < requests))
    interest = P.ProfileBuilder().add_single("serve").build()
    caches = T.init_caches(cfg, b, max_len, dev)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    tok0 = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    # the caches and lengths are the step's state (donated)
    [(entry, step)] = registry.start_function(interest, model, tok0, caches,
                                              lengths, mesh=mesh,
                                              donate_argnums=(2, 3))

    if prompts is None:
        prompts = prompts_for(cfg, requests, prompt_len, seed)
    prompts = torch.from_numpy(np.ascontiguousarray(prompts[rows])).to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    secs, gen = [], []
    launches0 = decode_attention.launches
    logits = None
    for t in range(prompt_len + tokens):
        if t < prompt_len:          # prefill: decode the prompt teacher-forced
            tok = prompts[:, t:t + 1]
        else:                       # generate greedily
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            gen.append(tok)
        sync()
        t0 = time.perf_counter()
        logits, caches, lengths = step(model, tok, caches, lengths)
        sync()
        secs.append(time.perf_counter() - t0)
        finite &= torch.isfinite(logits).all()
    launches = decode_attention.launches - launches0
    out = torch.cat(gen, dim=1) if gen \
        else torch.zeros((b, 0), dtype=torch.int32, device=dev)
    if group is not None and b < requests:  # every rank's rows, everywhere
        out = all_gather(out, group).reshape(requests, out.shape[1])
    return ServeResult(out.cpu().numpy(), secs, launches, bool(finite),
                       logits, caches, lengths, model, entry.name,
                       registry.statistics()["aot_cached"], step, rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_host_mesh(device=args.device)
    print(f"mesh: {axis_sizes(mesh)}  arch: {cfg.name}")
    res = run(cfg, args.requests, args.prompt_len, args.tokens,
              device=args.device, mesh=mesh)
    steps = len(res.secs)
    total = args.requests * steps
    print(f"resolved {res.resolved} via AR profile; AOT cache: "
          f"{res.aot_cached}; {res.launches} decode_attn kernel launches")
    print(f"generated {res.tokens.shape} tokens; {total / sum(res.secs):.0f} "
          f"tok/s total ({sum(res.secs) * 1e3 / steps:.1f} ms/step)")
    print("sample:", res.tokens[0, :16])


if __name__ == "__main__":
    main()
