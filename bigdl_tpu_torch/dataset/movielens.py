"""MovieLens ratings reader (counterpart of `bigdl_tpu/dataset/movielens.py`).

Parses ml-1m's `ratings.dat` (`user::movie::rating::timestamp`) or
ml-latest's `ratings.csv` (a header line, then `user,movie,rating,...`)
into the (user, item, rating) triples the Wide&Deep example consumes.
Nothing is downloaded: point it at a directory that already holds one of
the two files.
"""

from __future__ import annotations

import os

import numpy as np


def _rows(path: str, sep: str, header: bool):
    with open(path) as f:
        if header:
            next(f)
        for line in f:
            parts = line.strip().split(sep)
            if len(parts) >= 3:
                yield (int(parts[0]), int(parts[1]), int(float(parts[2])))


def read_data_sets(data_dir: str) -> np.ndarray:
    """[N, 3] int32 array of (user_id, movie_id, rating); a fractional
    rating is truncated. `ratings.dat` is read when both files are
    there."""
    dat = os.path.join(data_dir, "ratings.dat")
    csv = os.path.join(data_dir, "ratings.csv")
    if os.path.exists(dat):
        rows = list(_rows(dat, "::", header=False))
    elif os.path.exists(csv):
        rows = list(_rows(csv, ",", header=True))
    else:
        raise FileNotFoundError(f"no ratings.dat/ratings.csv in {data_dir}")
    return np.asarray(rows, np.int32)


def get_id_pairs(data_dir: str) -> np.ndarray:
    """[N, 2] (user_id, movie_id)."""
    return read_data_sets(data_dir)[:, :2]


def get_id_ratings(data_dir: str) -> np.ndarray:
    """[N, 3] (user_id, movie_id, rating)."""
    return read_data_sets(data_dir)
