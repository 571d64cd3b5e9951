"""The port's ServingEngine against the JAX package's, in float64 on the CPU.

For the same net (JAX parameters carried over with `params_from_jax`) and
the same request schedule, greedy tokens and the counted host syncs must be
identical to the JAX engine's: decode_chunk 1 and 8 with overlap on and off,
chunked prefill at a small budget, prefix sharing, mid-stream admission and
EOS. Inside the port: cached decode equals its own full recompute, K=1 and
K=8 give the same tokens at temperature > 0, the engine refuses to start
without CUDA unless asked for the CPU, and every unported option raises.
"""
import numpy as np
import pytest

import torch

from deeplearning4j_tpu import (Activation, InputType, MultiLayerNetwork,
                                NeuralNetConfiguration, RnnOutputLayer, Sgd,
                                WeightInit)
from deeplearning4j_tpu.nn.conf.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu.serving import Request as JaxRequest
from deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from deeplearning4j_tpu.serving.block_table import \
    chain_digests as jax_chain_digests
from deeplearning4j_tpu_torch.convert import conf_from_json, params_from_jax
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.serving import (KVCache, Request,
                                              ServingEngine, StackDecoder)
from deeplearning4j_tpu_torch.serving import engine as tengine
from deeplearning4j_tpu_torch.serving.block_table import chain_digests
from deeplearning4j_tpu_torch.serving.kv_cache import (advance_lengths,
                                                       append_token)
from deeplearning4j_tpu_torch.serving.policy import SchedulingPolicy

V = 13


def _nets(n_kv=2, window=0, seed=5):
    b = (NeuralNetConfiguration.Builder().seed(seed)
         .weight_init(WeightInit.XAVIER)
         .updater(Sgd(learning_rate=0.05)).dtype("float64").list())
    for _ in range(2):
        b.layer(SelfAttentionLayer(n_out=8, n_heads=4, n_kv_heads=n_kv,
                                   causal=True, block_size=0,
                                   attention_window=window))
    b.layer(RnnOutputLayer(n_out=V, activation=Activation.SOFTMAX))
    net = MultiLayerNetwork(
        b.set_input_type(InputType.recurrent(V)).build()).init()
    tnet = TNet(conf_from_json(net.conf.to_json()), device="cpu").init(
        params_from_jax(net.params_tree, device="cpu"))
    return net, tnet


@pytest.fixture(scope="module")
def nets():
    return _nets()


P1 = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
P2 = [8, 9, 10]


def _schedule(name, eng, req_cls):
    """Drive one scenario; returns the generated token lists."""
    if name in ("k1", "k8_overlap", "k8_sync"):
        return [r.tokens for r in eng.generate(
            [req_cls(P1, max_new_tokens=9), req_cls(P2, max_new_tokens=14)])]
    if name == "chunked_prefill":
        return [r.tokens for r in eng.generate(
            [req_cls(P1 + P2 + P1, max_new_tokens=7),
             req_cls(P2, max_new_tokens=12)])]
    if name == "prefix_sharing":
        shared = P1[:9]
        return [r.tokens for r in eng.generate(
            [req_cls(shared + [1, 2], max_new_tokens=6),
             req_cls(shared + [3], max_new_tokens=6),
             req_cls(shared + [1, 2], max_new_tokens=5)])]
    if name == "midstream_eos":
        f1 = eng.submit(req_cls(P1, max_new_tokens=12))
        for _ in range(3):
            eng.step()
        f2 = eng.submit(req_cls(P2, max_new_tokens=10, eos_id=EOS))
        f3 = eng.submit(req_cls([4, 5], max_new_tokens=6, eos_id=EOS))
        eng.drain()
        return [f.get(timeout=0).tokens for f in (f1, f2, f3)]
    raise ValueError(name)


EOS = 3
SCENARIOS = {
    "k1": dict(decode_chunk=1, overlap=False),
    "k8_overlap": dict(decode_chunk=8, overlap=True),
    "k8_sync": dict(decode_chunk=8, overlap=False),
    "chunked_prefill": dict(decode_chunk=8, overlap=True, prefill_chunk=8,
                            kv_block=4),
    "prefix_sharing": dict(decode_chunk=8, overlap=False, kv_block=4,
                           prefix_share=True),
    "midstream_eos": dict(decode_chunk=8, overlap=True),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_tokens_and_host_syncs_match_jax(nets, name):
    net, tnet = nets
    kw = dict(max_seqs=3, max_len=48, seed=0, **SCENARIOS[name])
    jeng = JaxEngine(net, **kw)
    teng = ServingEngine(tnet, device="cpu", **kw)
    ref = _schedule(name, jeng, JaxRequest)
    out = _schedule(name, teng, Request)
    assert out == ref
    js, ts = jeng.stats(), teng.stats()
    for key in ("host_syncs", "tokens_out", "prefix_hits",
                "prefix_shared_tokens", "prefill_chunks",
                "resident_seqs_max"):
        assert ts[key] == js[key], key
    # first-use shapes (prefill buckets, chunk lengths) count the same
    assert ts["jit_compiles"] == \
        jeng.metrics.get("serving.jit_compiles").value
    if name == "prefix_sharing":
        assert ts["prefix_hits"] >= 1
    if name == "chunked_prefill":
        assert ts["prefill_chunks"] >= 2
    if name == "midstream_eos":
        assert any(t and t[-1] == EOS for t in out[1:])


def _oracle_logprobs(tnet, tokens):
    x = torch.nn.functional.one_hot(torch.tensor(tokens), V).double().T[None]
    return torch.log(tnet.output(x)[0].clamp(min=1e-300)).numpy()


@pytest.mark.parametrize("n_kv,window", [(2, 0), (1, 3)])
def test_cached_decode_matches_full_recompute(n_kv, window):
    _, tnet = _nets(n_kv=n_kv, window=window)
    eng = ServingEngine(tnet, max_seqs=2, max_len=40, seed=0,
                        capture_logprobs=True, device="cpu")
    f1 = eng.submit(Request(P1, max_new_tokens=10))
    eng.step()
    f2 = eng.submit(Request(P2, max_new_tokens=8))
    eng.drain()
    for prompt, fut in ((P1, f1), (P2, f2)):
        res = fut.get(timeout=0)
        ref = _oracle_logprobs(tnet, list(prompt) + res.tokens)
        assert len(res.logprobs) == len(res.tokens)
        for i, lp in enumerate(res.logprobs):
            np.testing.assert_allclose(lp, ref[:, len(prompt) - 1 + i],
                                       atol=1e-9, rtol=0)


@pytest.mark.parametrize("top_k", [0, 4])
def test_sampled_tokens_identical_for_k1_and_k8(nets, top_k):
    _, tnet = nets
    runs = []
    for k in (1, 8):
        eng = ServingEngine(tnet, max_seqs=2, max_len=48, seed=11,
                            top_k=top_k, decode_chunk=k, overlap=False,
                            device="cpu")
        runs.append([r.tokens for r in eng.generate(
            [Request(P1, max_new_tokens=13, temperature=0.9),
             Request(P2, max_new_tokens=20, temperature=1.3)])])
    assert runs[0] == runs[1]
    greedy = ServingEngine(tnet, max_seqs=2, max_len=48, seed=11,
                           device="cpu").generate([Request(P1,
                                                           max_new_tokens=13)])
    assert greedy[0].tokens != runs[0][0]     # the draw is really sampled


def test_timeout_and_shutdown(nets):
    _, tnet = nets
    eng = ServingEngine(tnet, max_seqs=2, max_len=32, device="cpu")
    f = eng.submit(Request(P2, max_new_tokens=4, timeout_s=-1.0))
    eng.step()
    assert f.get(timeout=1).finish_reason == "timeout"
    eng.start()
    f2 = eng.submit(Request([4, 5], max_new_tokens=3))
    eng.shutdown(wait=True)
    assert len(f2.get(timeout=10).tokens) == 3


def test_engine_without_device_needs_cuda(nets):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    _, tnet = nets
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tnet, max_seqs=2, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TNet(tnet.conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StackDecoder(tnet, max_seqs=2, max_len=32)


@pytest.mark.parametrize("option", [k for k, _ in tengine._UNPORTED])
def test_unported_option_raises(nets, option):
    _, tnet = nets
    with pytest.raises(NotImplementedError, match=option):
        ServingEngine(tnet, max_seqs=2, max_len=32, device="cpu",
                      **{option: True})


@pytest.mark.parametrize("env", ["DL4J_TPU_PREFIX_RADIX", "DL4J_TPU_KV_EVICT",
                                 "DL4J_TPU_DISAGG"])
def test_unported_env_knob_raises(nets, env, monkeypatch):
    _, tnet = nets
    monkeypatch.setenv(env, "1")
    with pytest.raises(NotImplementedError):
        ServingEngine(tnet, max_seqs=2, max_len=32, device="cpu")


def test_non_colocated_policy_and_cache_options_raise(nets):
    _, tnet = nets
    with pytest.raises(NotImplementedError, match="policy"):
        ServingEngine(tnet, max_seqs=2, max_len=32, device="cpu",
                      policy=SchedulingPolicy())
    with pytest.raises(NotImplementedError):
        KVCache(1, 2, 8, 1, 2, torch.float64, device="cpu", prefix_radix=True)


def test_kv_append_in_place_with_trash_routing():
    """Appends land at each slot's own length through its block table, in
    place; an inactive slot's append goes to the trash block."""
    c = KVCache(n_layers=1, max_seqs=2, max_len=8, n_kv_heads=1, head_dim=2,
                dtype=torch.float64, block_size=4, device="cpu")
    assert c.allocate("a") == 0 and c.allocate("b") == 1
    st = c.state
    k_pool = st.k
    st.lengths[:] = torch.tensor([2, 0], dtype=torch.int32)
    k_t = torch.arange(4, dtype=torch.float64).reshape(2, 1, 2) + 1
    both = torch.tensor([True, True])
    append_token(st, 0, k_t, k_t, both)
    advance_lengths(st, both)
    bt = st.block_tables.numpy()
    np.testing.assert_allclose(st.k[0, bt[0, 0], 2, 0].numpy(), [1, 2])
    np.testing.assert_allclose(st.k[0, bt[1, 0], 0, 0].numpy(), [3, 4])
    assert st.lengths.tolist() == [3, 1]
    append_token(st, 0, k_t * 10, k_t * 10, torch.tensor([True, False]))
    np.testing.assert_allclose(st.k[0, bt[1, 0], 1, 0].numpy(), 0.0)
    np.testing.assert_allclose(st.k[0, c.trash_block, 1, 0].numpy(),
                               [30, 40])
    assert st.k is k_pool                   # mutated in place, never copied


def test_prefix_share_cow_and_ensure_writable():
    """A second request with a registered prompt maps the full prefix
    blocks shared and COW-copies the divergent tail block (the JAX
    admission plan); ensure_writable privatizes a shared block with a
    bit-exact copy and leaves the donor's mapping alone."""
    c = KVCache(n_layers=2, max_seqs=3, max_len=16, n_kv_heads=1,
                head_dim=2, dtype=torch.float64, block_size=4, device="cpu")
    prompt = list(range(10))
    a = c.admit("a", n_positions=12, prompt=prompt)
    c.state.k.normal_(generator=torch.Generator().manual_seed(0))
    c.register_prefix(a.slot, prompt)
    b = c.admit("b", n_positions=12, prompt=prompt)
    assert (b.shared_len, b.n_shared_blocks, b.cow) == (9, 2, True)
    assert c.blocks_shared == 2 and c.owner(b.slot) == "b"
    rows = c.state.block_tables.numpy()
    assert list(rows[b.slot, :2]) == list(rows[a.slot, :2])
    assert torch.equal(c.state.k[:, rows[b.slot, 2]],
                       c.state.k[:, rows[a.slot, 2]])
    shared = int(rows[b.slot, 1])
    assert c.ensure_writable(b.slot, 4, 6) == 1
    fresh = int(c.state.block_tables[b.slot, 1])
    assert fresh != shared and int(c.state.block_tables[a.slot, 1]) == shared
    assert torch.equal(c.state.k[:, fresh], c.state.k[:, shared])
    assert c.blocks_shared == 1
    c.free(a.slot)
    c.free(b.slot)
    assert c.blocks_free == c.num_blocks and c.blocks_shared == 0


def test_prefix_digests_match_jax():
    toks = list(range(37))
    assert chain_digests(toks, 8) == jax_chain_digests(toks, 8)
