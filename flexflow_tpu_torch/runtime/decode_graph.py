"""Decoding as captured CUDA graphs: one graph per decode signature.

The JAX package runs a whole ``generate`` as one jitted ``lax.scan`` of
single-token steps, compiled once per ``(B, P, N, sampled, top_k, top_p,
inputs)`` key (model.py:2573-2601 there).  The card's counterpart is one
captured step replayed T = P + N - 1 times: every step reads and writes
only static buffers, so no host read happens between replays and the
tokens come back in one copy at the end.

A signature's static buffers:

- ``feed`` (T, B): the prompt, then zeros; ``use`` (T,): whether step t
  feeds the prompt token or the carry;
- ``tok`` (B,): the carried token; ``counter`` (1,): the step index on the
  device (the decode position of ``generate``);
- the decode caches (``FFModel.init_decode_caches``), zeroed before a call;
- ``out`` (T, B): every step's token;
- sampled decoding: ``temp`` (a device scalar) and ``noise`` (B, V),
  drawn before each replay from a ``torch.Generator`` on the device seeded
  from ``seed``.  Neither the seed nor the temperature keys the signature,
  as in the JAX package.

``beam_search`` has two graphs over one set of buffers: the prompt steps
(the caches fill, nothing expands) and the expanding steps (top-K over
K * V candidates, then every cache gathered in place by the surviving
beams' parents).  The host knows which step is which, so no branch is
captured.

``DecodeGraph`` is ``StepGraph``'s control flow (runtime/step_graph.py):
the first step of a signature runs eagerly on a side stream, the next is
captured and replayed, then replays; a failed capture raises.  Captures
are thread-local, so the serving engine can capture in its worker thread
(or a replica pool restart in its monitor thread) while other threads use
the card; each in a graph memory pool of its own, one at a time in the
process (``capture_lock``).  On the CPU, under ``disable_graphs()`` and
on a mesh the same step runs eagerly over the same buffers: a mesh step is
DTensor ops and their collectives, run by every rank of the process group
in lockstep, as the mesh training step runs (``FFModel._use_graph``).
``GenerateRun`` and ``BeamRun`` are the same on every rank: each draws its
noise from a generator seeded alike and reads the same whole
probabilities, so every rank ends with the same tokens.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .step_graph import StepGraph, graphs_enabled


def cache_leaves(caches):
    """The tensors of a decode-cache tree ({op: None or {name: tensor}})."""
    return [c for entry in caches.values() if entry for c in entry.values()]


class DecodeGraph(StepGraph):
    """One decode step of one signature, advanced ``n`` steps at a time."""

    capture_error_mode = "thread_local"

    def __init__(self, device: torch.device, step: Callable[[], None],
                 use_graph: Optional[Callable[[], bool]] = None):
        super().__init__(device)
        self.step = step
        # whether a step is captured: the model's own rule
        # (``FFModel._use_graph``: never on a mesh), else on any CUDA device
        self.use_graph = use_graph

    def _use_graph(self) -> bool:
        if self.use_graph is not None:
            return self.use_graph()
        return self.device.type == "cuda" and graphs_enabled()

    def advance(self, n: int, before: Optional[Callable[[], None]] = None) -> None:
        """Run the step ``n`` times; ``before`` runs ahead of each step,
        outside any graph (drawing the next step's noise)."""
        for _ in range(n):
            if before is not None:
                before()
            if self._use_graph():
                self.run("step", self.step)
            else:
                self.step()


class _Run:
    """What a generate and a beam signature share: the feed, the step
    counter, the caches and the static inputs (a seq2seq encoder's
    outputs, computed once a call)."""

    def __init__(self, model, rows: int, P: int, N: int, tok_t, pos_t, extra_guids,
                 static_ops, static_names, repeat: int = 1):
        dev = model.device
        self.model, self.P, self.N, self.T = model, P, N, P + N - 1
        self.tok_t, self.pos_t = tok_t, pos_t
        self.extra_guids, self.static_ops, self.static_names = \
            extra_guids, static_ops, static_names
        self.repeat = repeat
        self.feed = torch.zeros(self.T, rows // repeat, dtype=torch.long, device=dev)
        self.use = torch.zeros(self.T, dtype=torch.bool, device=dev)
        self.counter = torch.zeros(1, dtype=torch.long, device=dev)
        self.caches = model.init_decode_caches(rows, P + N, skip=static_names)
        self.pre_env: Optional[Dict[int, torch.Tensor]] = None
        self.graphs = []

    @property
    def captures(self) -> int:
        return sum(g.captures for g in self.graphs)

    @property
    def capture_s(self) -> float:
        return sum(g.capture_s for g in self.graphs)

    def _reset(self, toks: np.ndarray, extra) -> None:
        """Stage a call: the prompt into the feed, zeroed caches and
        counter, and the static inputs' outputs into their buffers."""
        P, T = self.P, self.T
        feed = np.zeros((T, toks.shape[0]), np.int64)
        feed[:P] = toks.T
        use = np.zeros(T, bool)
        use[:P] = True
        self.feed.copy_(torch.from_numpy(feed))
        self.use.copy_(torch.from_numpy(use))
        self.counter.zero_()
        for c in cache_leaves(self.caches):
            c.zero_()
        env = self.model._prefill_static(self.model._decode_params(), extra,
                                         self.extra_guids, self.static_ops, self.repeat)
        if self.pre_env is None:
            self.pre_env = env
        else:
            for g, t in env.items():
                self.pre_env[g].copy_(t)

    def _probs(self, cur: torch.Tensor) -> torch.Tensor:
        m = self.model
        probs, _ = m.decode_step(m._decode_params(), self.caches, cur,
                                 self.counter[0], self.tok_t, self.pos_t,
                                 pre_env=self.pre_env, skip=self.static_names)
        return probs

    def _fed(self, carry: torch.Tensor) -> torch.Tensor:
        """This step's input tokens: the prompt's while it lasts (one per
        beam), else the carry."""
        i = self.counter
        feed = self.feed.index_select(0, i)[0]
        if self.repeat > 1:
            feed = feed[:, None].expand(-1, self.repeat).reshape(-1)
        return torch.where(self.use.index_select(0, i), feed, carry)


class GenerateRun(_Run):
    """One ``generate`` signature: greedy, or sampled at a temperature with
    ``top_k``/``top_p`` masks (the JAX package's step, model.py:2535-2568)."""

    def __init__(self, model, B, P, N, sampled: bool, top_k, top_p, tok_t, pos_t,
                 extra_guids, static_ops, static_names):
        super().__init__(model, B, P, N, tok_t, pos_t, extra_guids, static_ops,
                         static_names)
        dev = model.device
        self.sampled, self.top_k, self.top_p = sampled, top_k, top_p
        self.tok = torch.zeros(B, dtype=torch.long, device=dev)
        self.out = torch.zeros(self.T, B, dtype=torch.long, device=dev)
        if sampled:
            vocab = model.final_tensor().dims[-1]
            self.temp = torch.zeros((), device=dev)
            self.noise = torch.zeros(B, vocab, device=dev)
            self.gen = torch.Generator(device=dev)
        self.graphs = [DecodeGraph(dev, self._step, model._use_graph)]

    def _step(self) -> None:
        with torch.no_grad():
            cur = self._fed(self.tok)
            probs = self._probs(cur)
            nxt = self._sample(probs) if self.sampled else torch.argmax(probs, dim=-1)
            self.out.index_copy_(0, self.counter, nxt[None])
            self.tok.copy_(nxt)
            self.counter.add_(1)

    def _sample(self, probs: torch.Tensor) -> torch.Tensor:
        """Gumbel-max over the masked logits at temperature ``temp``.  The
        masks compare with the k-th probability and the nucleus cutoff, so
        sort order among equal probabilities never matters."""
        logits = torch.log(probs + 1e-9)
        if self.top_k is not None or self.top_p is not None:
            srt = torch.sort(probs, dim=-1, descending=True).values
            V = srt.shape[1]
            if self.top_k is not None:
                k = min(self.top_k, V)
                logits = torch.where(probs >= srt[:, k - 1:k], logits, float("-inf"))
            if self.top_p is not None:
                # the smallest prefix of mass >= p; its lowest probability is
                # the cutoff (the top token always survives).  Clamped: a row
                # summing just under 1.0 would index past V at p = 1.0
                csum = torch.cumsum(srt, dim=-1)
                keep_n = torch.clamp((csum < self.top_p).sum(-1), max=V - 1)
                cutoff = torch.gather(srt, 1, keep_n[:, None])
                logits = torch.where(probs >= cutoff, logits, float("-inf"))
        gumbel = -torch.log(-torch.log(self.noise))
        return torch.argmax(logits / self.temp + gumbel, dim=-1)

    def __call__(self, toks: np.ndarray, extra, temperature: float, seed: int) -> np.ndarray:
        self._reset(toks, extra)
        self.tok.zero_()
        before = None
        if self.sampled:
            self.temp.fill_(float(temperature))
            self.gen.manual_seed(int(seed))

            def before():
                self.noise.uniform_(generator=self.gen)
        self.graphs[0].advance(self.T, before)
        return self.out[self.P - 1:].T.cpu().numpy().astype(np.int32)


class BeamRun(_Run):
    """One ``beam_search`` signature (the JAX package's model.py:2643-2726):
    B * K rows; the prompt steps fill the caches; each expanding step keeps
    the top K of the K * V candidate scores and gathers every cache, the
    token buffer and the scores by the surviving beams' parents, in place
    through a temporary."""

    def __init__(self, model, B, P, N, K, eos_id, tok_t, pos_t, extra_guids, static_ops,
                 static_names):
        super().__init__(model, B * K, P, N, tok_t, pos_t, extra_guids, static_ops,
                         static_names, repeat=K)
        dev = model.device
        self.B, self.K, self.eos_id = B, K, eos_id
        self.buf = torch.zeros(B * K, N, dtype=torch.long, device=dev)
        self.scores = torch.zeros(B, K, device=dev)
        self.last = torch.zeros(B * K, dtype=torch.long, device=dev)
        self.base = torch.arange(B, device=dev)[:, None] * K
        self.prompt_graph = DecodeGraph(dev, self._prompt_step, model._use_graph)
        self.expand_graph = DecodeGraph(dev, self._expand_step, model._use_graph)
        self.graphs = [self.prompt_graph, self.expand_graph]

    def _prompt_step(self) -> None:
        with torch.no_grad():
            cur = self._fed(self.last)
            self._probs(cur)
            self.last.copy_(cur)
            self.counter.add_(1)

    def _expand_step(self) -> None:
        with torch.no_grad():
            B, K, N = self.B, self.K, self.N
            cur = self._fed(self.last)
            logp = torch.log(self._probs(cur) + 1e-30)  # (BK, V)
            V = logp.shape[-1]
            if self.eos_id is not None:
                # freeze on the token at THIS position (cur): a finished beam
                # can only emit eos again, at log-prob 0
                frozen = torch.where(torch.arange(V, device=logp.device) == self.eos_id,
                                     0.0, float("-inf"))
                logp = torch.where((cur == self.eos_id)[:, None], frozen[None], logp)
            total = self.scores.reshape(B, K, 1) + logp.reshape(B, K, V)
            top, idx = torch.topk(total.reshape(B, K * V), K)
            flat = (torch.div(idx, V, rounding_mode="floor") + self.base).reshape(-1)
            token = (idx % V).reshape(-1)
            for c in cache_leaves(self.caches):
                c.copy_(c.index_select(0, flat))
            self.buf.copy_(self.buf.index_select(0, flat))
            widx = torch.clamp(self.counter - (self.P - 1), 0, N - 1)
            self.buf.index_copy_(1, widx, token[:, None])
            self.scores.copy_(top)
            self.last.copy_(token)
            self.counter.add_(1)

    def __call__(self, toks: np.ndarray, extra):
        B, K, N = self.B, self.K, self.N
        self._reset(toks, extra)
        self.buf.zero_()
        self.last.zero_()
        # beams 1..K-1 start at -inf, so the first expansion draws from beam 0
        self.scores.fill_(float("-inf"))
        self.scores[:, 0].zero_()
        self.prompt_graph.advance(self.P - 1)
        self.expand_graph.advance(N)
        return (self.buf.reshape(B, K, N).cpu().numpy().astype(np.int32),
                self.scores.cpu().numpy())
