"""Speculative decoding under KV pressure, the port against the JAX
package in float64 on the CPU: preempted spec requests resume by
recompute and by asynchronous swap with their n-gram draft index rebuilt
from prompt + history, and give the JAX engine's tokens, timeline phases,
host syncs and spec counters."""
import pytest

import torch

from tests.test_torch_kv_lifecycle import _assert_parity, _both, _nets

torch.set_num_threads(1)    # small CPU tensors: one thread per test process


@pytest.fixture(scope="module")
def nets():
    return _nets()


@pytest.mark.parametrize("mode,async_", [("recompute", False),
                                         ("swap", True)])
def test_spec_decode_under_pressure_matches_jax(nets, mode, async_,
                                                tmp_path):
    jax_run, port_run = _both(nets, "all_at_once", tmp_path,
                              kv_evict="lru", kv_evict_mode=mode,
                              kv_swap_async=async_, kv_swap_bytes=1 << 24,
                              spec_decode=True, spec_draft=3)
    _assert_parity(jax_run, port_run)
    js, ts = jax_run[0].stats(), port_run[0].stats()
    for key in ("spec_tokens_accepted", "spec_tokens_rejected"):
        assert ts[key] == js[key], key
    assert ts["kv_preemptions"] >= 4 and ts["spec_tokens_accepted"] > 0
