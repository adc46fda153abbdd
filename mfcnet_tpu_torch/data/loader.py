"""Host loader and prefetcher (counterpart of ``mfcnet_tpu/data/loader.py``).

:class:`DataLoader` shuffles, batches and reads samples on a thread pool,
two batches ahead. Under the same seed it gives the JAX loader's sample
order: after ``set_epoch(epoch)`` the permutation is
``np.random.default_rng([seed, epoch])``'s, and ``skip_batches`` drops
the epoch's first batches (a resumed epoch continues where it stopped).
``shard=(rank, count)`` gives rank ``rank`` of ``count`` processes its
strided share of that permutation, as the JAX loader does.
:class:`Prefetcher` runs the device transform (upload + augmentation) one
batch ahead on a background thread.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np


def _collate(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Shuffling, batching host loader over an indexable dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0,
                 drop_last: bool = False, shard: Optional[tuple] = None):
        """``shard=(rank, count)``: every process shuffles the same
        permutation, truncates it to a multiple of ``count`` and takes
        ``idxs[rank::count]``; every rank then holds ``len(dataset) //
        count`` samples and runs the same number of steps (a rank with one
        batch more would wait for the others at a collective forever)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.shard = shard
        self._epoch = None
        self._skip_batches = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0):
        """Make the next iteration's shuffle a function of (seed, epoch)
        and skip its first ``skip_batches`` batches (read nothing for
        them)."""
        self._epoch = int(epoch)
        self._skip_batches = max(0, int(skip_batches))

    def __len__(self):
        n = len(self.dataset)
        if self.shard is not None:
            n //= self.shard[1]
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def order(self) -> np.ndarray:
        """The sample indices of the next iteration, in order (consumes
        ``skip_batches``)."""
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            if self._epoch is not None:
                np.random.default_rng([self.seed, self._epoch]).shuffle(idxs)
            else:
                self.rng.shuffle(idxs)
        if self.shard is not None:
            rank, count = self.shard
            idxs = idxs[: (len(idxs) // count) * count][rank::count]
        if self.drop_last:
            idxs = idxs[: len(self) * self.batch_size]
        if self._skip_batches:
            idxs = idxs[self._skip_batches * self.batch_size:]
            self._skip_batches = 0
        return idxs

    def __iter__(self) -> Iterator[dict]:
        idxs = self.order()
        batches = [idxs[i: i + self.batch_size]
                   for i in range(0, len(idxs), self.batch_size)]
        with ThreadPoolExecutor(self.num_workers) as pool:
            def submit(batch):
                return [pool.submit(self.dataset.__getitem__, int(j))
                        for j in batch]

            # the batch being read plus two ahead
            futures = [submit(b) for b in batches[:3]]
            for nxt in range(3, len(batches) + 3):
                fs = futures.pop(0)
                if nxt < len(batches):
                    futures.append(submit(batches[nxt]))
                yield _collate([f.result() for f in fs])
                if not futures:
                    break


class Prefetcher:
    """Runs ``device_fn`` on each batch of ``host_iter`` one step ahead on
    a background thread. An exception there (a KeyboardInterrupt
    included) is raised on the consumer's side."""

    def __init__(self, host_iter, device_fn: Optional[Callable] = None,
                 depth: int = 2):
        self.host_iter = iter(host_iter)
        self.device_fn = device_fn
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for batch in self.host_iter:
                if self.device_fn is not None:
                    batch = self.device_fn(batch)
                self.q.put(batch)
        except BaseException as e:  # re-raised by __next__
            self.q.put(e)
        finally:
            self.q.put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is StopIteration:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item


def get_data_loader(dataset_name: str, data_dir, mode: str,
                    prediction_task: str, num_input_frames: int,
                    batch_size: int, num_workers: int = 4,
                    fold_index: int = -1, add_depth_inputs: bool = False,
                    seed: int = 0, shard: Optional[tuple] = None,
                    packed_dir=None):
    """Multi-frame loaders (reference src/dataloader_multiframe.py:225-317):
    training mode returns (train loader shuffled at ``batch_size``, val
    loader at batch 1), testing mode (None, test loader). ``shard=(rank,
    count)`` splits the training samples over processes (see
    :class:`DataLoader`); validation stays whole on every rank. ``packed_dir``
    reads packs (``train/`` + ``val/`` or ``test/``) instead of decoding
    the image tree; a pack made for another task, dataset or fold
    raises."""
    def loaders(train_ds, val_ds):
        return (DataLoader(train_ds, batch_size, shuffle=True,
                           num_workers=num_workers, seed=seed, shard=shard),
                DataLoader(val_ds, 1, shuffle=False,
                           num_workers=num_workers))

    if packed_dir is not None:
        from mfcnet_tpu_torch.data.packed import PackedMultiFrameDataset

        packed_dir = Path(packed_dir)
        expect = {"prediction_task": prediction_task,
                  "dataset": dataset_name, "fold_index": fold_index}

        def pack(split, exp):
            return PackedMultiFrameDataset(packed_dir / split,
                                           num_input_frames,
                                           add_depth_inputs, expect=exp)

        if mode == "training":
            return loaders(pack("train", expect), pack("val", expect))
        return None, DataLoader(pack("test", {**expect, "mode": mode}), 1,
                                num_workers=num_workers)

    from mfcnet_tpu_torch.data.dataset import MultiFrameDataset
    from mfcnet_tpu_torch.data.files import get_dataset_filenames

    train_files, val_files = get_dataset_filenames(dataset_name, data_dir,
                                                   mode, fold_index)

    def files(names):
        return MultiFrameDataset(names, prediction_task, num_input_frames,
                                 add_depth_inputs)

    if mode == "training":
        return loaders(files(train_files), files(val_files))
    return None, DataLoader(files(train_files), 1, num_workers=num_workers)
