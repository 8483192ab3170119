"""Entry points of the port run on the CUDA card unless the caller asks
for the CPU: every public constructor called without ``device`` lands
on the card, and without a card it raises -- nothing falls back to the
CPU.  The test decides at run time which of the two holds."""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import profiles, serverless, store
from repro_torch.configs import smoke_config
from repro_torch.data import ringbuffer
from repro_torch.launch import serve
from repro_torch.models import griffin, moe, rwkv, transformer
from repro_torch.obs import latency
from repro_torch.runtime.overlap import IngestStager
from repro_torch.stream import StreamConfig, ingest
from repro_torch.stream.fleet import FleetConfig, FleetExecutor

def _fleet():
    """A 2-shard fleet built without ``device``: its state's ring."""
    from repro_torch.core import pipeline, rules
    engine = rules.RuleEngine([rules.threshold_rule(
        "hot", 0, ">=", 1.0, rules.C_SEND_CORE)])
    ex = FleetExecutor(
        FleetConfig(stream=StreamConfig(micro_batch=8, window=4, stride=4,
                                        capacity=16), num_shards=2),
        engine, pipeline.two_tier_pipeline(lambda p, b: (b, b[:, :5]),
                                           lambda p, b: (b, b[:, :5]),
                                           engine))
    return ex.init_state(2).shard.rb.store


def _gen() -> torch.Generator:
    """A generator where the constructor under test draws: the card's
    when there is one."""
    return torch.Generator("cuda" if torch.cuda.is_available() else "cpu")


CONSTRUCTORS = {
    "ringbuffer.create": lambda: ringbuffer.create(4, (2,)).store,
    "latency.histogram_init": lambda: latency.histogram_init(),
    "latency.lineage_init": lambda: latency.lineage_init(),
    "ingest.admission_init":
        lambda: ingest.admission_init(ingest.AdmissionPlan(8)).seen,
    "IngestStager": lambda: torch.empty(0, device=IngestStager().device),
    "store.init_store": lambda: store.init_store(4, 2).keys,
    "profiles.batch_profiles":
        lambda: profiles.batch_profiles([profiles.profile("a")]),
    "FunctionRegistry":
        lambda: torch.empty(0, device=serverless.FunctionRegistry().device),
    "convert.histograms_from_numpy":
        lambda: convert.histograms_from_numpy(np.zeros(3), np.zeros(3))[0],
    "convert.params_from_numpy":
        lambda: convert.params_from_numpy(np.zeros(3)),
    "transformer.init_params":
        lambda: transformer.init_params(smoke_config("yi_6b")).embed,
    "transformer.init_caches":
        lambda: transformer.init_caches(smoke_config("yi_6b"), 2, 4)[0]["k"],
    "griffin.init_rglru_block": lambda: griffin.init_rglru_block(
        _gen(), 16, griffin.RGLRUConfig(d_rnn=16), torch.float32)["w_x"],
    "rwkv.init_time_mix": lambda: rwkv.init_time_mix(
        _gen(), 16, rwkv.RWKVConfig(n_heads=2, d_head=8, decay_lora=4),
        torch.float32)["wr"],
    "rwkv.init_channel_mix": lambda: rwkv.init_channel_mix(
        _gen(), 16, 32, torch.float32)["wk"],
    "moe.init_moe": lambda: moe.init_moe(
        _gen(), 16, moe.MoEConfig(num_experts=4, top_k=2, d_ff=32),
        torch.float32)["w_in"],
    "transformer.init_caches[rwkv]":
        lambda: transformer.init_caches(smoke_config("rwkv6_7b"), 2, 4)[0][
            "tmix"]["wkv"],
    "transformer.init_caches[rec]":
        lambda: transformer.init_caches(smoke_config("recurrentgemma_2b"),
                                        2, 4)[0]["rec"]["h"],
    "convert.caches_from_numpy":
        lambda: convert.caches_from_numpy(smoke_config("yi_6b"), [{"pos0": {
            "attn": {"k": np.zeros((2, 1, 4, 2, 16), np.float32),
                     "v": np.zeros((2, 1, 4, 2, 16), np.float32)}}}])[0]["k"],
    "serve.run": lambda: serve.run(smoke_config("yi_6b"), 2, 2, 2).logits,
    "FleetExecutor": _fleet,
}


def _controller():
    """A controller over a fleet built without ``device``: its executor's
    knobs are host numpy, so the card is where its executor lives."""
    from repro_torch.stream.fleet import FleetController
    from repro_torch.core import pipeline, rules
    engine = rules.RuleEngine([rules.threshold_rule(
        "hot", 0, ">=", 1.0, rules.C_SEND_CORE)])
    ex = FleetExecutor(
        FleetConfig(stream=StreamConfig(micro_batch=8, window=4, stride=4,
                                        capacity=16), num_shards=2),
        engine, pipeline.two_tier_pipeline(lambda p, b: (b, b[:, :5]),
                                           lambda p, b: (b, b[:, :5]),
                                           engine))
    ctl = FleetController(ex)
    st = ex.init_state(2)
    st, _ = ex.step(st, np.zeros((2, 8, 2), np.float32),
                    np.tile(np.arange(8, dtype=np.float32), (2, 1)))
    ctl.tick(st, step_times=np.full(2, 0.1))
    return ctl.begin_replay_carry(st, 0, 1).shard.carry


CONSTRUCTORS["FleetController"] = _controller


def _train_state():
    """The trainable model built without ``device``; its AdamW state
    follows the parameters."""
    from repro_torch import optim
    model = transformer.init_params(smoke_config("yi_6b"), trainable=True)
    return optim.init(model, optim.AdamWConfig()).m["embed"]


def _from_reference():
    """``convert``'s training helpers without ``device``, on a tree with
    the reference's layout (the port's own state written out)."""
    from repro_torch import optim
    cfg = smoke_config("yi_6b")
    model = transformer.init_params(cfg, device="cpu", trainable=True)
    params, st = convert.train_state_to_numpy(
        cfg, model, optim.init(model, optim.AdamWConfig()))
    built = convert.train_model_from_numpy(cfg, params)
    assert built.embed.device == convert.adamw_state_from_numpy(
        cfg, built, st).m["embed"].device
    return built.embed


def _prefetched():
    from repro_torch.data import Prefetcher
    pf = Prefetcher(iter([{"x": np.zeros(2, np.float32)}]))
    try:
        return next(pf)["x"]
    finally:
        pf.close()


def _trained():
    from repro_torch.launch import train
    return train.run(smoke_config("yi_6b"), 1, 2, 8).model.embed


CONSTRUCTORS.update({
    "transformer.init_params[trainable]": _train_state,
    "convert.train_model_from_numpy": _from_reference,
    "Prefetcher": _prefetched,
    "train.run": _trained,
})


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    if torch.cuda.is_available():
        assert CONSTRUCTORS[name]().is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CONSTRUCTORS[name]()


@pytest.mark.parametrize("kind", ["stream", "fleet"])
def test_step_cost_runs_on_the_executors_device(kind, monkeypatch):
    """``step_cost`` moves numpy operands to the executor's own device
    and runs the tick there: every tensor the analysis sees is on it."""
    from repro_torch.core import pipeline, rules
    from repro_torch.obs import costmodel
    from repro_torch.stream import StreamExecutor
    engine = rules.RuleEngine([rules.threshold_rule(
        "hot", 0, ">=", 1.0, rules.C_SEND_CORE)])
    pipe = pipeline.two_tier_pipeline(lambda p, b: (b, b[:, :5]),
                                      lambda p, b: (b, b[:, :5]), engine)
    cfg = StreamConfig(micro_batch=8, window=4, stride=4, capacity=16)
    ex = StreamExecutor(cfg, engine, pipe, device="cpu") if kind == "stream" \
        else FleetExecutor(FleetConfig(stream=cfg, num_shards=2), engine,
                           pipe, device="cpu")
    items = np.zeros((8, 2) if kind == "stream" else (2, 8, 2), np.float32)
    ts = np.zeros(items.shape[:-1], np.float32)
    seen = set()
    real = costmodel._Analysis.count

    def count(self, func, args, kwargs, out):
        seen.update(t.device.type for t in costmodel._tensors((args, out)))
        return real(self, func, args, kwargs, out)
    monkeypatch.setattr(costmodel._Analysis, "count", count)
    assert ex.step_cost(ex.init_state(2), items, ts)["bytes_accessed"] > 0
    assert seen == {ex.device.type}
