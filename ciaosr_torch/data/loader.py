"""Prefetching data loader on the host, in threads or forked processes.

Counterpart of ciaosr_tpu/data/loader.py, with its contract: the index
stream (a permutation of the dataset per epoch from
``numpy.random.default_rng(seed)``, batches of ``batch_size``), an ordered
merge (batch ``seq`` comes out ``seq``-th whichever worker made it), a
worker's error re-raised in the consumer (never a hang), and a shutdown
that joins the threads when the iterator is closed.

Randomness: the samples of batch ``seq`` draw, in order, from
``numpy.random.default_rng((seed, seq))`` (``dataset.load(idx, rng)``),
in both worker modes, as the JAX package's process workers do; a dataset
with a ``seed`` of its own keeps its per-sample generators. So a thread
run, a process run and the JAX package's process run give the same
batches.

Batches stay numpy on the host; workers never touch CUDA (a forked child
of a process with a live CUDA context must not initialise it). The
trainer moves each batch to the device.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np


def default_collate(samples: list[dict]) -> dict:
    """Stack array fields; collect 'meta' dicts into a list."""
    out = {}
    for k in samples[0]:
        if k == "meta":
            out["meta"] = [s["meta"] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


def load_batch(dataset, chunk, seed: int, seq: int) -> dict | None:
    """Batch ``seq``: the samples of ``chunk`` drawing in order from
    ``default_rng((seed, seq))``, collated (None if every sample is)."""
    rng = np.random.default_rng((seed, seq))
    samples = [dataset.load(int(i), rng) for i in chunk]
    samples = [s for s in samples if s is not None]
    return default_collate(samples) if samples else None


_FORK_DATASET = None  # inherited by fork-started pool workers


def _proc_load_batch(chunk, seed, seq):  # runs in child processes
    return load_batch(_FORK_DATASET, chunk, seed, seq)


class DataLoader:
    """Infinite (or single-pass) shuffling loader with prefetching workers.

    ``worker_mode``: "thread" (default; numpy's resize and the PNG
    decoder's zlib release the GIL) or "process" (a fork-started pool, for
    pipelines bound by Python code).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4, infinite: bool = True,
                 worker_mode: str = "thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', "
                             f"got {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.infinite = infinite
        self.worker_mode = worker_mode

    def _index_stream(self):
        rng = np.random.default_rng(self.seed)
        while True:
            order = (rng.permutation(len(self.dataset)) if self.shuffle
                     else np.arange(len(self.dataset)))
            for i in range(0, len(order), self.batch_size):
                chunk = order[i:i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                yield chunk
            if not self.infinite:
                return

    def __iter__(self):
        if self.worker_mode == "process" and self.num_workers > 1:
            return self._iter_processes()
        return self._iter_threads()

    def _iter_processes(self):
        """Futures consumed in submission order (the ordered merge);
        ``result()`` re-raises a child's exception; closing cancels the
        queued work."""
        import multiprocessing as mp
        from collections import deque
        from concurrent.futures import ProcessPoolExecutor

        global _FORK_DATASET
        _FORK_DATASET = self.dataset  # visible to fork children, no pickling
        ex = ProcessPoolExecutor(max_workers=self.num_workers,
                                 mp_context=mp.get_context("fork"))
        try:
            stream = enumerate(self._index_stream())
            window: deque = deque()
            depth = max(self.prefetch, self.num_workers)
            exhausted = False
            while True:
                while not exhausted and len(window) < depth:
                    try:
                        seq, chunk = next(stream)
                    except StopIteration:
                        exhausted = True
                        break
                    window.append(ex.submit(_proc_load_batch,
                                            [int(i) for i in chunk],
                                            self.seed, seq))
                if not window:
                    return
                try:
                    batch = window.popleft().result()
                except Exception as e:
                    raise RuntimeError("DataLoader worker failed") from e
                if batch is not None:
                    yield batch
        finally:
            _FORK_DATASET = None
            ex.shutdown(wait=False, cancel_futures=True)

    def _iter_threads(self):
        batch_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        idx_q: queue.Queue = queue.Queue(maxsize=self.prefetch * 2)
        stop = threading.Event()
        pending: dict[int, dict | None] = {}
        pending_lock = threading.Lock()
        errors: list[BaseException] = []

        def feeder():
            for seq, chunk in enumerate(self._index_stream()):
                if stop.is_set():
                    return
                idx_q.put((seq, chunk))
            for _ in range(self.num_workers):
                idx_q.put(None)

        def worker():
            while not stop.is_set():
                item = idx_q.get()
                if item is None or stop.is_set():
                    break
                seq, chunk = item
                try:
                    batch = load_batch(self.dataset, chunk, self.seed, seq)
                except BaseException as e:  # noqa: BLE001 — must not hang
                    # a read racing a shutdown is expected; anything else
                    # must reach the consumer, or the ordered merge waits
                    # on this seq forever
                    if not stop.is_set():
                        errors.append(e)
                        stop.set()
                    break
                with pending_lock:
                    pending[seq] = batch
                batch_q.put(seq)
            batch_q.put(None)

        threads = [threading.Thread(target=feeder, daemon=True,
                                    name="loader-feeder")]
        threads += [threading.Thread(target=worker, daemon=True,
                                     name=f"loader-worker-{i}")
                    for i in range(self.num_workers)]
        for t in threads:
            t.start()

        next_seq, done_workers = 0, 0
        try:
            while True:
                if errors:
                    raise RuntimeError("DataLoader worker failed") \
                        from errors[0]
                with pending_lock:
                    ready = next_seq in pending
                    batch = pending.pop(next_seq, None)
                if ready:
                    next_seq += 1
                    if batch is not None:
                        yield batch
                    continue
                if done_workers >= self.num_workers:
                    # every worker ended: the stream is exhausted
                    with pending_lock:
                        rest = [pending.pop(s) for s in sorted(pending)]
                    yield from (b for b in rest if b is not None)
                    return
                try:
                    if batch_q.get(timeout=0.01) is None:
                        done_workers += 1
                except queue.Empty:
                    pass
        finally:
            # join every thread: a worker that outlives a closed iterator
            # races whatever the dataset reads from
            stop.set()
            deadline = time.time() + 10.0
            alive = list(threads)
            while alive and time.time() < deadline:
                for q in (idx_q, batch_q):
                    while True:           # drop queued work and results
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            break
                for _ in alive:           # wake workers blocked on get
                    try:
                        idx_q.put_nowait(None)
                    except queue.Full:
                        break
                for t in alive:
                    t.join(0.05)
                alive = [t for t in alive if t.is_alive()]


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 4,
                     shuffle: bool = True, seed: int = 0, **kwargs):
    return DataLoader(dataset, batch_size=samples_per_gpu,
                      num_workers=workers_per_gpu, shuffle=shuffle,
                      seed=seed, **kwargs)
