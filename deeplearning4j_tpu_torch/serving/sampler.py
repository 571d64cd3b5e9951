"""Token sampling: greedy / temperature / top-k (counterpart of
serving/sampler.py).

`sample_tokens` is one sync-free function over a batch of logprob rows with
per-row temperatures: greedy rows take `argmax` (the first maximal index,
as jnp.argmax), sampled rows take the Gumbel-max draw
argmax(logits / T + Gumbel noise), with the noise from `torch.rand` on an
explicit generator.

Random draws are keyed by CHAIN POSITION, not by a running stream: the
`Sampler` hands out integer positions (`next_key`, `peek_keys`,
`advance`, the JAX Sampler's interface) and the draw for position i is
seeded from (engine seed, i). Micro-step i of a K-step chunk therefore uses
exactly the draw the i-th sequential step would have used, so K in {1, 8}
gives the same tokens even at temperature > 0. The draws are not jax's
threefry bits; sampled tokens match across the two packages only in
distribution.
"""
from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device

NEG_INF = -1e30
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def draw_seed(seed: int, position: int) -> int:
    """The generator seed of chain position `position` (a splitmix64 step
    over (seed, position), so neighbouring positions are unrelated)."""
    z = (int(seed) * _MIX + int(position) + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _MASK


def sample_tokens(logprobs: torch.Tensor, temperature: torch.Tensor,
                  top_k: int = 0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Draw one token per row. logprobs (S, V) (any log-space scores);
    temperature (S,) on the same device, 0 -> greedy; top_k 0/>=V disables.
    `generator` (on the logprobs' device) feeds the Gumbel noise; None means
    every row is greedy and nothing is drawn. Returns (S,) int32 tokens."""
    logprobs = logprobs.float()
    S, V = logprobs.shape
    greedy = torch.argmax(logprobs, dim=-1).to(torch.int32)
    if generator is None:
        return greedy
    temperature = temperature.to(torch.float32)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logprobs / safe_t[:, None]
    if top_k and top_k < V:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, NEG_INF)
    u = torch.rand((S, V), generator=generator, device=logprobs.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature > 0, drawn.to(torch.int32), greedy)


def spec_accept_tokens(sampler: "Sampler", positions, logprobs, draft,
                       draft_len, temperature, any_sampled: bool = True):
    """Speculative accept/resample for DETERMINISTIC (n-gram) drafts,
    batched and sync-free.

    positions: Q chain positions (Sampler.peek_keys); row i samples at
    positions[i], exactly the draw the i-th sequential decode step would
    use. logprobs (S, Q, V): verified target rows, row i conditioned on the
    last committed token plus drafts 0..i-1; draft (S, Q-1) proposed
    tokens; draft_len (S,) how many leading draft rows are real (0 = plain
    decode step); temperature (S,) as in `sample_tokens`.

    With a point-mass draft, accepting d_i with probability p_i(d_i) and
    resampling the residual on reject collapse into one draw t_i from the
    target row: the commit is the sampled tokens up to and including the
    first mismatch. Because each row uses its sequential chain position and,
    on the accepted prefix, the same conditioning, the committed tokens
    equal plain decode's on the same chain (greedy: argmax comparison).

    Returns (tokens (S, Q) int32, n_accept (S,) drafts accepted, n_commit
    (S,) = n_accept + 1 tokens to commit)."""
    S, Q, V = logprobs.shape
    toks = torch.stack([sampler.sample(logprobs[:, i], temperature,
                                       positions[i], any_sampled)
                        for i in range(Q)], dim=1)               # (S, Q)
    i = torch.arange(Q - 1, device=logprobs.device)[None, :]
    ok = (toks[:, :-1] == draft) & (i < draft_len[:, None])       # (S, Q-1)
    n_accept = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    return toks, n_accept.to(torch.int32), (n_accept + 1).to(torch.int32)


class Sampler:
    """Sampling config plus the chain position counter. `peek_keys(n)` are
    the next n positions without advancing; `advance(n)` commits n;
    `next_key()` == peek_keys(1)[0] + advance(1)."""

    def __init__(self, seed: int = 0, top_k: int = 0,
                 device: DeviceLike = "cuda"):
        """`device` holds the noise generator: the card unless the caller
        asks for the CPU."""
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        self.seed = int(seed)
        self.top_k = int(top_k)
        self._pos = 0
        self._gen = torch.Generator(device=resolve_device(device))

    def next_key(self) -> int:
        pos = self._pos
        self._pos += 1
        return pos

    def peek_keys(self, n: int):
        return list(range(self._pos, self._pos + n))

    def advance(self, n: int) -> None:
        self._pos += int(n)

    def generator(self, position: int) -> torch.Generator:
        """The generator seeded for chain `position` (host-side seeding,
        no device sync)."""
        return self._gen.manual_seed(draw_seed(self.seed, position))

    def sample(self, logprobs, temperature, position: int,
               any_sampled: bool = True):
        """sample_tokens at chain `position`; `any_sampled` False (all rows
        greedy, known on the host) skips the noise draw."""
        gen = self.generator(position) if any_sampled else None
        return sample_tokens(logprobs, temperature, self.top_k, gen)
