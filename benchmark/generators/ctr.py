"""CTR training batches: a pool made from a mix's parameters
(``traffic/<mix>.json`` with ``"generator": "ctr"``) and the run's seed.

A mix gives:

- ``ids``: the law of each field's ids, ``{"law": <name>, ...}``, drawn by
  ``laws/<name>.py``'s ``ids``;
- ``dense``: the law of the dense features, drawn by ``laws/<name>.py``'s
  ``values``;
- ``positive_rate``: the share of labels that are 1;
- ``pool_batches``: how many batches the pool holds.

Everything is drawn on ``device`` from one ``torch.Generator`` seeded with
the run's traffic seed, in a fixed order, in a few large calls, then copied
to the host once: the same seed on the same kind of device gives the same
pool.  The window replays the pool in order.
"""
from __future__ import annotations

import numpy as np
import torch

from benchkit import registry


def make_pool(mix: dict, table_rows, num_dense: int, batch: int, seed: int,
              device="cpu") -> list[dict]:
    """``mix['pool_batches']`` host batches, each ``{'sparse': (batch, F)
    int32, 'dense': (batch, num_dense) float32, 'label': (batch,)
    float32}``, views into three contiguous arrays."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    pool = int(mix["pool_batches"])
    n = pool * batch
    id_law = registry.law(mix["ids"]["law"])
    cols = [id_law.ids(gen, n, int(rows), mix["ids"], device) for rows in table_rows]
    sparse = torch.stack(cols, 1).to(torch.int32)
    dense = registry.law(mix["dense"]["law"]).values(gen, (n, num_dense), mix["dense"], device)
    label = (torch.rand(n, generator=gen, device=device) < float(mix["positive_rate"]))
    sparse, dense, label = (x.cpu().numpy() for x in (sparse, dense, label.float()))
    sparse = sparse.reshape(pool, batch, -1)
    dense = np.ascontiguousarray(dense, np.float32).reshape(pool, batch, num_dense)
    label = label.reshape(pool, batch)
    return [{"sparse": sparse[i], "dense": dense[i], "label": label[i]} for i in range(pool)]
