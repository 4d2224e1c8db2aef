"""The device work of a retrieve's decode (``ops/beam.py::generate_cids``:
encoder, decode caches, every beam step) replayed as a chain of CUDA
graphs.

The search yields a device flag at each early-exit check, which the host
reads (``beam.alive``); between two checks the work depends on tensors
alone, so each stretch is captured once as one graph, a *piece*.  With
progressive widening at beam 100 and kary 30 over four positions the
pieces are the encoder, the caches and the two widening steps; the step
at position 2; the step at position 3.  A replay runs a piece, reads its
flag and replays the next only while a beam still runs, so the early exit
and its host syncs are the eager search's.

- **One implementation.**  Capture runs the search generator itself, sent
  True at every check.  The pieces share one graph memory pool and are
  captured in order, so the state one piece leaves is the next piece's
  input at a fixed address; the state at each check is kept for an exit
  there.  Only the query ids and mask are copied in, once a retrieve.
  A recurrent state (Kimi Linear's KDA layers, the cache's ``rec_``
  entries) lives in two buffers a layer that the widening steps make in
  the pool and later steps write in place, alternating, so every piece
  finds it at a fixed address.
  Python's cyclic garbage collector is off while a chain captures: a
  collection there could free the graphs of a chain its caller dropped,
  and CUDA refuses to destroy a graph while a stream captures, which
  fails the capture.
- **When.**  :meth:`DecodeGraphs.engages`: a CUDA model in eval mode (a
  graph would replay the dropout draws), autograd off, no capture under
  way.  Everything else runs eagerly.
- **Which chain.**  A chain is keyed on the inputs' shapes and dtypes, the
  search's settings, the model's dtype and device, the TF32 setting, and
  the address of every tensor the graphs read from outside the chain
  (parameters, buffers, trie, U table): an in-place update is read by the
  next replay, a new tensor captures anew.  The first decode of a key runs
  eagerly (it makes the GEMM plans, the split-K counters and the rel-bias
  ids that a capture may not make); the second captures and replays.  At
  most :data:`CHAINS` keys are held, the least recent dropped first.
- **Counts.**  A replay calls no kernel wrapper, so each capture takes a
  snapshot of the counter registry (``utils/timing.py``) and puts it back
  after, keeping the launches the wrappers counted meanwhile as the
  piece's count, which each replay adds.  The registry also counts the
  pieces captured and replayed and the eager CUDA decodes.
- **Outputs.**  What a piece leaves lives in the pool and is overwritten
  by the next replay: ``beam._finalize`` copies the beams out, and the
  query embedding and encoder states are cloned here.
"""

from __future__ import annotations

import gc
from collections import OrderedDict
from dataclasses import dataclass

import torch

from gdr_tpu_torch.ops.beam import alive, drive
from gdr_tpu_torch.utils.timing import count, counts, restore, span

CHAINS = 4


@dataclass
class _Piece:
    graph: torch.cuda.CUDAGraph
    pos: int                       # the first position it decodes
    launches: dict[str, int]       # kernel launches a replay makes
    flag: torch.Tensor | None      # the check after it; None: the end
    out: tuple                     # (state, query emb, enc) on exit here


class _Chain:
    """The pieces of one key, captured from ``decode(ids, mask)`` (a
    ``beam._decode`` generator) on ``stream``."""

    def __init__(self, decode, ids, mask, max_len: int, stream):
        self.ids, self.mask = ids.clone(), mask.clone()
        pool = torch.cuda.graph_pool_handle()
        steps = decode(self.ids, self.mask)
        stream.wait_stream(torch.cuda.current_stream(ids.device))
        captured = []                  # (graph, launches, flag, state)
        result = None
        collecting = gc.isenabled()
        gc.disable()                   # no graph freed mid-capture
        try:
            while result is None:
                graph = torch.cuda.CUDAGraph()
                before = counts()
                try:
                    with torch.cuda.stream(stream):
                        graph.capture_begin(pool=pool)
                        try:
                            flag, state = (steps.send(True) if captured
                                           else next(steps))
                        except StopIteration as stop:
                            result, flag, state = stop.value, None, None
                        finally:
                            graph.capture_end()
                finally:               # a capture launches nothing
                    launched = {k: n - before[k] for k, n in counts().items()
                                if n != before[k]}
                    restore(before)
                count("graph_captures")
                captured.append((graph, launched, flag, state))
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(ids.device).wait_stream(stream)
        _, query_emb, enc = result
        n = len(captured)
        self.pieces = [
            _Piece(graph, 0 if i == 0 else max_len - n + i, launched, flag,
                   result if flag is None else (state, query_emb, enc))
            for i, (graph, launched, flag, state) in enumerate(captured)]

    def replay(self, ids, mask):
        """(state, query embedding, encoder states) of ``ids``, ``mask``;
        the state lives in the pool until the next replay."""
        self.ids.copy_(ids)
        self.mask.copy_(mask)
        for piece in self.pieces:
            with span("gdr.decode.replay", f"pos={piece.pos}"):
                piece.graph.replay()
            count("graph_replays")
            for name, n in piece.launches.items():
                count(name, n)
            if piece.flag is None or not alive(piece.flag):
                break
        state, query_emb, enc = piece.out
        return state, query_emb.clone(), enc.clone()


class DecodeGraphs:
    """The CUDA graph chains of one caller's decodes (an ``Evaluator``'s),
    at most :data:`CHAINS` of them, and the side stream they are captured
    on."""

    def __init__(self):
        self._chains: OrderedDict = OrderedDict()   # key -> _Chain | None
        self._stream = None

    @staticmethod
    def engages(model, input_ids: torch.Tensor) -> bool:
        """Whether a decode of ``model`` on ``input_ids`` runs as graphs."""
        return (input_ids.is_cuda and not model.training
                and not torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing())

    def run(self, model, decode, input_ids, attn_mask, max_len: int,
            settings: tuple, reads: tuple):
        """What ``drive(decode(input_ids, attn_mask))`` returns, by the
        chain of this key.  ``settings``: the search's arguments that shape
        its work; ``reads``: the tensors besides the model's that it reads
        (None for absent ones)."""
        key = (tuple(input_ids.shape), input_ids.dtype,
               tuple(attn_mask.shape), attn_mask.dtype, input_ids.device,
               model.dtype, torch.backends.cuda.matmul.allow_tf32, settings,
               tuple(None if t is None else t.data_ptr() for t in reads),
               tuple(p.data_ptr() for p in model.parameters()),
               tuple(b.data_ptr() for b in model.buffers()))
        seen = key in self._chains
        chain = self._chains.pop(key, None)
        if seen and chain is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(input_ids.device)
            chain = _Chain(decode, input_ids, attn_mask, max_len,
                           self._stream)
        self._chains[key] = chain
        while len(self._chains) > CHAINS:
            self._chains.popitem(last=False)
        if chain is None:                  # the first decode of this key
            count("eager_decodes")
            return drive(decode(input_ids, attn_mask))
        return chain.replay(input_ids, attn_mask)
