"""The census of the tape recorder's walks (K13a, K13b, K13a+K13b).

`walk_census` walks the rays with the plain march's sample chain
(`ops/tape.py` `_walk_plain`, on any device) and counts what each design of
the recorder walks and stages (PERF.md §6, `tools/tape_record_ab.py`):

  * ``count_steps``: the steps of the count walk, every step of every ray
    (the sum of the total counts);
  * ``record_steps``: the steps of the earlier record walk (K13b), which
    also walks every ray to its end;
  * ``stop_steps``: the record walk ending, in compact mode, at each ray's
    last occupied sample; ``resume_stop_steps``: also starting at its first
    one (in full mode both equal ``record_steps``);
  * each ray's empty steps split into ``prefix`` (before its first occupied
    sample), ``interior`` and ``suffix`` (after its last), and
    ``empty_ray_steps``, the steps of rays with no occupied sample;
  * the arena's chunks, entries, padding and bytes under two layouts, for
    recorded samples of ``entry_bytes`` (4 a stream) and chunks of
    ``chunk`` entries: (ii), the shipped one, a chunk of a ray's samples
    (8 bytes of owner a chunk); (i), a chunk of ``chunk`` steps x 32 lanes
    of a warp of 32 consecutive rays, lane-minor (8 bytes a chunk).
"""

from __future__ import annotations

import torch

from ..utils.spec import RenderOptions
from .render import _ray_setup
from .tape import ARENA_CHUNK, _occupied, _walk_plain


def walk_census(spec, n_rows: int, origins, dirs, opt: RenderOptions, compact: bool,
                entry_bytes: int = 12, chunk: int = ARENA_CHUNK) -> dict:
    """The census of a recording of these rays (see the module's doc)."""
    B, dev = origins.shape[0], origins.device
    rays = _ray_setup(spec, origins, dirs, opt)
    none = torch.full((B,), -1, dtype=torch.long, device=dev)
    first, last = none.clone(), none.clone()
    n_tot = torch.zeros(B, dtype=torch.long, device=dev)
    n_occ = torch.zeros_like(n_tot)
    for active, leaf, _, _ in _walk_plain(spec, opt, rays):
        occ = active & _occupied(leaf.data_idx, n_rows)
        first = torch.where(occ & (first < 0), n_tot, first)
        last = torch.where(occ, n_tot, last)
        n_tot += active.long()
        n_occ += occ.long()
    hit = first >= 0
    span = torch.where(hit, last - first + 1, 0)
    counts = n_occ if compact else n_tot
    out = {
        "rays": B, "walked_rays": int((n_tot > 0).sum()), "samples": int(counts.sum()),
        "occupied": int(n_occ.sum()), "count_steps": int(n_tot.sum()), "record_steps": int(n_tot.sum()),
        "stop_steps": int(torch.where(hit, last + 1, 0).sum()) if compact else int(n_tot.sum()),
        "resume_stop_steps": int(span.sum()) if compact else int(n_tot.sum()),
        "prefix": int(first[hit].sum()), "interior": int((span - n_occ)[hit].sum()),
        "suffix": int((n_tot - 1 - last)[hit].sum()), "empty_ray_steps": int(n_tot[~hit].sum()),
    }
    ray_chunks = (counts + chunk - 1) // chunk
    pad = (-B) % 32
    per_warp = torch.cat([counts, counts.new_zeros(pad)]).reshape(-1, 32).amax(1)
    warp_chunks = (per_warp + chunk - 1) // chunk
    for name, n_chunks, per_chunk in (("ii", int(ray_chunks.sum()), chunk),
                                      ("i", int(warp_chunks.sum()), chunk * 32)):
        entries = n_chunks * per_chunk
        out[f"arena_{name}"] = dict(chunks=n_chunks, entries=entries, padding=entries - out["samples"],
                                    bytes=entries * entry_bytes + n_chunks * 8)
    return out
