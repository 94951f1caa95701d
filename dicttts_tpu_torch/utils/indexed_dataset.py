"""Random-access record file: pickled items in `.data`, byte offsets in `.idx`.

Port of ``dicttts_tpu/utils/indexed_dataset.py``, in the same format: `.idx`
is a numpy-saved dict ``{'offsets': [0, o1, ...]}`` and `.data` holds the
concatenated pickles (protocol 4). The reader keeps an LRU cache keyed by
index. Unpickling runs code, so read only files this project wrote.
"""

from __future__ import annotations

import pickle
from collections import OrderedDict

import numpy as np


class IndexedDataset:
    def __init__(self, path: str, num_cache: int = 1):
        self.path = path
        idx = np.load(f"{path}.idx", allow_pickle=True).item()
        self.offsets = idx["offsets"]
        self._file = open(f"{path}.data", "rb", buffering=-1)
        self._cache: OrderedDict[int, object] = OrderedDict()
        self._num_cache = num_cache

    def __getitem__(self, i: int):
        if i < 0 or i >= len(self):
            raise IndexError(f"index {i} out of range [0, {len(self)})")
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        self._file.seek(self.offsets[i])
        item = pickle.loads(self._file.read(self.offsets[i + 1] - self.offsets[i]))
        if self._num_cache > 0:
            self._cache[i] = item
            while len(self._cache) > self._num_cache:
                self._cache.popitem(last=False)
        return item

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IndexedDatasetBuilder:
    def __init__(self, path: str):
        self.path = path
        self._file = open(f"{path}.data", "wb")
        self.offsets = [0]

    def add_item(self, item):
        n = self._file.write(pickle.dumps(item, protocol=4))
        self.offsets.append(self.offsets[-1] + n)

    def finalize(self):
        self._file.close()
        np.save(open(f"{self.path}.idx", "wb"), {"offsets": self.offsets})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
