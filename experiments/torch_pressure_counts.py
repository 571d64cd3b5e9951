#!/usr/bin/env python3
"""Preemption counts of the JAX engine and of the port on the schedule of
chip_smoke.py's kv_pressure phase, on the CPU:

    JAX_PLATFORMS=cpu python3 experiments/torch_pressure_counts.py \
        [--new-tokens N] [--modes recompute,swap_sync,swap_async_disk]

from the repo root. The schedule is the phase's: max_seqs 8, max_len 1024,
KV blocks of 16 positions, a pool of 200 blocks, max_new_tokens_cap 256,
stepped synchronously (overlap off), kv_evict "lru"; a warmup request,
then 4 requests of 512 random tokens (seed 0) and N new tokens (default
256), 4 more submitted once half of the first wave's tokens are out. The
model is narrower than the phase's (2 causal GQA attention layers of
width 8, 4 heads, 2 KV heads, vocabulary 64, float64, seed 5): the
scheduler's decisions depend on lengths and block counts, not on widths.
The asynchronous swap's host pool holds one and a half requests' blocks of
this model and spills into a disk tier under a temporary directory, as in
the phase. Prints one JSON object:
{"schedule": {...}, "modes": {mode: {"jax": {...}, "port": {...},
"tokens_equal": bool}}}.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VOCAB, PROMPT, WAVE = 64, 512, 4
MAX_SEQS, MAX_LEN, KV_BLOCK = 2 * WAVE, 1024, 16
# float64 k and v of 2 KV heads of width 2 in 2 layers
BLOCK_BYTES = KV_BLOCK * 2 * 2 * 2 * 2 * 8
MODES = {"recompute": dict(kv_evict_mode="recompute"),
         "swap_sync": dict(kv_evict_mode="swap", kv_swap_async=False,
                           kv_swap_bytes=1 << 30),
         "swap_async_disk": dict(kv_evict_mode="swap", kv_swap_async=True)}
STATS = ("kv_preemptions", "kv_evictions_recompute", "kv_evictions_swap",
         "kv_swap_harvests", "kv_disk_demotions", "kv_disk_promotions",
         "host_syncs", "tokens_out", "admission_retries")


def build_nets():
    """The same float64 weights as a JAX network and as the port's."""
    from deeplearning4j_tpu import (Activation, InputType,
                                    MultiLayerNetwork,
                                    NeuralNetConfiguration, RnnOutputLayer,
                                    Sgd, WeightInit)
    from deeplearning4j_tpu.nn.conf.layers.attention import \
        SelfAttentionLayer
    from deeplearning4j_tpu_torch.convert import (conf_from_json,
                                                  params_from_jax)
    from deeplearning4j_tpu_torch.nn.multilayer import \
        MultiLayerNetwork as TNet
    b = (NeuralNetConfiguration.Builder().seed(5)
         .weight_init(WeightInit.XAVIER)
         .updater(Sgd(learning_rate=0.05)).dtype("float64").list())
    for _ in range(2):
        b.layer(SelfAttentionLayer(n_out=8, n_heads=4, n_kv_heads=2,
                                   causal=True, block_size=0))
    b.layer(RnnOutputLayer(n_out=VOCAB, activation=Activation.SOFTMAX))
    net = MultiLayerNetwork(
        b.set_input_type(InputType.recurrent(VOCAB)).build()).init()
    tnet = TNet(conf_from_json(net.conf.to_json()), device="cpu").init(
        params_from_jax(net.params_tree, device="cpu"))
    return net, tnet


def drive(eng, req_cls, new_tokens):
    """chip_smoke.py's serve_traffic, stepped synchronously."""
    import numpy as np
    rng = np.random.RandomState(0)

    def prompt():
        return rng.randint(0, VOCAB, PROMPT).tolist()

    eng.generate([req_cls(prompt(),
                          max_new_tokens=max(2, 2 * eng.decode_chunk))])
    eng.metrics.reset()
    futs = [eng.submit(req_cls(prompt(), max_new_tokens=new_tokens))
            for _ in range(WAVE)]
    midpoint = WAVE * (new_tokens // 2)
    while eng.tokens_out < midpoint and eng.step():
        pass
    futs += [eng.submit(req_cls(prompt(), max_new_tokens=new_tokens))
             for _ in range(WAVE)]
    eng.drain()
    return [f.get(timeout=0).tokens for f in futs]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--new-tokens", type=int, default=256)
    ap.add_argument("--modes", default=",".join(MODES))
    args = ap.parse_args()
    import jax
    jax.config.update("jax_enable_x64", True)   # float64, as the tests
    import torch
    torch.set_num_threads(1)
    from deeplearning4j_tpu.serving import Request as JaxRequest
    from deeplearning4j_tpu.serving import ServingEngine as JaxEngine
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine
    # the phase's pool: wave 1's blocks and 8 more
    positions = PROMPT + args.new_tokens
    kv_blocks = WAVE * positions // KV_BLOCK + positions // KV_BLOCK // 6
    net, tnet = build_nets()
    out = {"schedule": {"prompt": PROMPT, "new_tokens": args.new_tokens,
                        "wave": WAVE, "max_seqs": MAX_SEQS,
                        "kv_block": KV_BLOCK, "kv_blocks": kv_blocks,
                        "overlap": False},
           "modes": {}}
    spill = tempfile.TemporaryDirectory()
    for mode in args.modes.split(","):
        row, toks = {}, {}
        for tag, cls, req, n, kw in (
                ("jax", JaxEngine, JaxRequest, net, {}),
                ("port", ServingEngine, Request, tnet, {"device": "cpu"})):
            if mode == "swap_async_disk":
                kw = dict(kw, kv_swap_bytes=BLOCK_BYTES * -(
                    -positions // KV_BLOCK) * 3 // 2,
                          kv_disk=os.path.join(spill.name, mode, tag))
            eng = cls(n, max_seqs=MAX_SEQS, max_len=MAX_LEN,
                      max_new_tokens_cap=args.new_tokens, kv_block=KV_BLOCK,
                      kv_blocks=kv_blocks, overlap=False, kv_evict="lru",
                      **MODES[mode], **kw)
            t0 = time.perf_counter()
            toks[tag] = drive(eng, req, args.new_tokens)
            st = eng.stats()
            row[tag] = {k: st[k] for k in STATS}
            row[tag]["wall_s"] = time.perf_counter() - t0
            eng.shutdown()
        row["tokens_equal"] = toks["jax"] == toks["port"]
        row["counts_equal"] = all(row["jax"][k] == row["port"][k]
                                  for k in STATS)
        out["modes"][mode] = row
        print(json.dumps({mode: row}), file=sys.stderr, flush=True)
    spill.cleanup()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
