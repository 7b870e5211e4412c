"""MovieLens-1M bipartite recommendation dataset (copy of
euler_tpu/dataset/ml_1m.py: RecData, _synthetic_ratings, ml_1m;
tests/test_torch_data.py pins it to the original).

As in tf_euler/python/dataset/ml_1m.py: users and items are two node
types, one 'rated' edge type weighted by the rating, with reverse edges
for item-side hops; the unsupervised runners (DeepWalk, LINE) train
embeddings on the rated edges.

Resolution order:
  1. $EULER_TPU_DATA_DIR/ml_1m/ratings.dat  ("user::item::rating::ts")
  2. synthetic stand-in with MovieLens-1M statistics: 6040 users ×
     3706 items, ~1M ratings from clustered preferences (users and items
     share latent genres, so embedding models learn a real structure).

Node ids: users are 1..U, items are U+1..U+I (the reference offsets item
ids the same way to keep one id space).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from euler_tpu_torch.dataset.base_dataset import DATA_DIR_ENV
from euler_tpu_torch.graph import GraphBuilder, GraphEngine

USER_TYPE, ITEM_TYPE = 0, 1
RATED_EDGE = 0


@dataclass
class RecData:
    engine: GraphEngine
    num_users: int
    num_items: int
    name: str = "ml_1m"
    source: str = "synthetic"

    @property
    def max_id(self) -> int:
        return self.num_users + self.num_items


def _synthetic_ratings(num_users: int, num_items: int, num_ratings: int,
                       n_genres: int = 18, seed: int = 0) -> np.ndarray:
    """(user, item, rating) rows; users prefer items of their favored
    genres with higher ratings."""
    rng = np.random.default_rng(seed)
    user_genre = rng.integers(0, n_genres, num_users)
    item_genre = rng.integers(0, n_genres, num_items)
    # popularity skew (zipf-ish) like real MovieLens
    item_pop = 1.0 / (1.0 + np.arange(num_items)) ** 0.7
    item_pop /= item_pop.sum()
    # real ratings are unique (user, item) pairs; oversample then dedupe
    users = rng.integers(0, num_users, int(num_ratings * 1.3))
    items = rng.choice(num_items, size=users.size, p=item_pop)
    _, keep = np.unique(users.astype(np.int64) * num_items + items,
                        return_index=True)
    keep = np.sort(keep)[:num_ratings]
    users, items = users[keep], items[keep]
    num_ratings = users.size
    match = user_genre[users] == item_genre[items]
    rating = np.where(match,
                      rng.integers(4, 6, num_ratings),
                      rng.integers(1, 4, num_ratings)).astype(np.float32)
    return np.stack([users + 1,
                     items + 1 + num_users,
                     rating], axis=1)


def ml_1m(num_users: int = 6040, num_items: int = 3706,
          num_ratings: int = 1_000_209, seed: int = 0) -> RecData:
    source = "synthetic"
    rows = None
    data_dir = os.environ.get(DATA_DIR_ENV, "")
    path = os.path.join(data_dir, "ml_1m", "ratings.dat") if data_dir else ""
    if path and os.path.exists(path):
        raw = []
        with open(path, encoding="latin-1") as f:
            for line in f:
                parts = line.strip().split("::")
                if len(parts) >= 3:
                    raw.append((int(parts[0]), int(parts[1]),
                                float(parts[2])))
        arr = np.array(raw, dtype=np.float64)
        # raw MovieLens ids are sparse (movie ids run past the movie
        # count); size the id space from the FILE, not the defaults, so
        # every item node is pre-typed and max_id covers the table
        num_users = int(arr[:, 0].max())
        num_items = int(arr[:, 1].max())
        rows = np.stack([arr[:, 0], arr[:, 1] + num_users, arr[:, 2]],
                        axis=1)
        source = "local"
    if rows is None:
        rows = _synthetic_ratings(num_users, num_items, num_ratings,
                                  seed=seed)

    b = GraphBuilder()
    b.set_num_types(2, 1)
    user_ids = np.arange(1, num_users + 1, dtype=np.uint64)
    item_ids = np.arange(num_users + 1, num_users + num_items + 1,
                         dtype=np.uint64)
    b.add_nodes(user_ids, types=np.full(num_users, USER_TYPE, np.int32))
    b.add_nodes(item_ids, types=np.full(num_items, ITEM_TYPE, np.int32))
    src = rows[:, 0].astype(np.uint64)
    dst = rows[:, 1].astype(np.uint64)
    w = rows[:, 2].astype(np.float32)
    b.add_edges(src, dst, weights=w)
    b.add_edges(dst, src, weights=w)  # reverse edges for item-side hops
    return RecData(b.finalize(), num_users, num_items, source=source)
