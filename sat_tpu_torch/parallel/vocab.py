"""Vocab tensor parallelism: the embedding table and the final decode
projection split over the mesh's ``model`` axis.

The JAX package gets this from GSPMD: the placement rule shards the
vocabulary-sized leaves (``parallel.sharding``) and XLA compiles the
collectives.  Here each model rank holds rows ``[o, o + V/m)`` of the
embedding table and the same columns of the last decode layer, and the
decoder calls the hooks below where a single device would touch the
full vocabulary:

* :meth:`VocabParallel.embed` — the lookup of ids outside this block
  reads zeros, then the rows are summed over the group (identity
  backward: the embedding feeds replicated work);
* :meth:`VocabParallel.enter` — the decode input entering the sharded
  projection (its gradient is summed over the group);
* :meth:`VocabParallel.token_ce` — cross-entropy over the sharded logits:
  the MAX over the group with no gradient, the SUM of the exps, a masked
  pick of the target logit;
* :meth:`VocabParallel.argmax` — the global argmax with the lower index
  first among equal values (``jnp.argmax``'s rule);
* :meth:`VocabParallel.gather` — the full-width logits (inference, before
  the search's ``top_k``), a zero-padded SUM.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from .collectives import MIN, all_reduce_, all_reduce_max, copy_to, reduce_from, zero_padded_gather


class VocabParallel:
    def __init__(self, mesh, vocabulary_size: int) -> None:
        self.group = mesh.group("model")
        self.index = mesh.index("model")
        self.size = mesh.size("model")
        self.vocabulary_size = int(vocabulary_size)
        self.width = self.vocabulary_size // self.size
        self.offset = self.index * self.width

    def _local(self, ids: torch.Tensor):
        """(ids as indices into this block, clamped; which ids it holds)."""
        local = ids.long() - self.offset
        inside = (local >= 0) & (local < self.width)
        return local.clamp(0, self.width - 1), inside

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        local, inside = self._local(ids)
        rows = torch.where(inside.unsqueeze(-1), table[local], torch.zeros((), dtype=table.dtype,
                                                                          device=table.device))
        return reduce_from(rows, self.group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.group)

    def gather(self, logits: torch.Tensor) -> torch.Tensor:
        return zero_padded_gather(logits, logits.dim() - 1, self.index, self.size, self.group)

    def token_ce(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Per-token cross-entropy [B, T] from this block's logits
        [B, T, V/m]: ``m + log Σ exp(l − m) − l_target`` in float32, the
        shift ``m`` the global max held out of the gradient."""
        lf = logits.float()
        m = all_reduce_max(lf.amax(dim=-1), self.group)
        s = reduce_from(torch.exp(lf - m.unsqueeze(-1)).sum(dim=-1), self.group)
        local, inside = self._local(targets)
        picked = lf.gather(-1, local.unsqueeze(-1))[..., 0]
        target = reduce_from(torch.where(inside, picked, torch.zeros((), device=lf.device)), self.group)
        return m + torch.log(s) - target

    @torch.no_grad()
    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        values, idx = logits.float().max(dim=-1)
        best = all_reduce_max(values, self.group)
        candidate = torch.where(values == best, idx + self.offset, torch.full_like(idx, self.vocabulary_size))
        return all_reduce_(candidate, self.group, MIN)


def vocab_parallel(config: Config, mesh) -> Optional[VocabParallel]:
    """The hooks of ``mesh``'s model axis, or None where the vocabulary is
    whole on each rank: a model axis of size 1, or one that context
    parallelism spends on the grid."""
    if mesh.size("model") == 1 or config.context_parallel > 1:
        return None
    return VocabParallel(mesh, config.vocabulary_size)
