"""Collective bytes per kind of a step (the counterpart of
``repro.launch.hlo_stats``).

JAX parses the compiled module's text and sums the result-shape bytes of
every collective op. The port has no compiled module: its collectives
are the calls of ``models.partitioning``, so ``CollectiveRecorder``
records each one as it is issued (``partitioning.recording``) and sums
the bytes of the tensor the ranks all-reduce, per device:

- ``reduce_model`` counts as "all-reduce", at the bytes of the partial
  sum;
- ``gather_model``, ``gather_data`` and FSDP's ``gather_fsdp`` count as
  "all-gather", at the bytes of the full-width buffer that every rank
  fills with its slab and zeros. On the wire the port's gather is an
  all-reduce of that buffer (``partitioning._gather``), so these are the
  bytes that buffer holds, not the bytes of one slab;
- ``gather_fsdp``'s backward counts as "reduce-scatter", at the bytes of
  the full-width gradient the ranks all-reduce before each keeps its
  shard; a training step's other sums (``enter_model``'s backward,
  ``sum_data``, ``sum_grads``) as "all-reduce".

``stats()`` has ``collective_bytes``' keys: the five kinds, ``n_<kind>``
(calls) and ``total`` (bytes). The port issues no all-to-all or
collective-permute, so those stay 0. ``by_axis()`` splits the bytes by
mesh axis ("model", "data", "pod"), for the roofline's link rates.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import partitioning as P

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class CollectiveRecorder:
    """``with CollectiveRecorder() as rec: step()`` records every
    collective the step issues through ``models.partitioning``."""

    def __init__(self):
        self.bytes: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
        self.counts: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
        self.axis_bytes: Dict[str, int] = {}
        self._rec = P.recording(self._note)

    def _note(self, kind: str, axis: str, x: torch.Tensor) -> None:
        n = x.numel() * x.element_size()
        self.bytes[kind] += n
        self.counts[kind] += 1
        self.axis_bytes[axis] = self.axis_bytes.get(axis, 0) + n

    def __enter__(self):
        self._rec.__enter__()
        return self

    def __exit__(self, *exc):
        return self._rec.__exit__(*exc)

    def stats(self) -> Dict[str, int]:
        """Bytes and calls per kind, and their total bytes."""
        return {**self.bytes,
                **{f"n_{k}": v for k, v in self.counts.items()},
                "total": sum(self.bytes.values())}

    def by_axis(self) -> Dict[str, int]:
        return dict(self.axis_bytes)
