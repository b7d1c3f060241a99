"""Background-threaded batch pipeline: sample -> augment -> queue.

The reference hides augmentation latency behind a process pool
(MultiThreadedAugmenter, data_augmentation_moreDA.py:163 + pin-memory
thread); here a daemon thread (or several) keeps a small queue of augmented
numpy batches that the trainer converts to device tensors, overlapping
host work with the card's compute. Each thread draws from its own
RandomState(seed + i); the sampler is shared, so only one thread gives a
fixed order of batches. With raw=True (the trainer's device_augment
mode) a worker only samples crops at the generator patch and queues
{"data", "seg"} unaugmented, for ops/device_augment.py to augment on the
card.

The port's own copy of e2enet_tpu/data/pipeline.py (the port imports
nothing of the JAX package).
"""
import queue
import threading

import numpy as np

from .augment import AugmentParams, augment_batch
from .sampler import PatchSampler3D


class BatchPipeline:
    def __init__(self, sampler: PatchSampler3D, params: AugmentParams,
                 validation: bool = False, num_threads: int = 1,
                 queue_size: int = 4, seed: int = 0, raw: bool = False):
        self.sampler = sampler
        self.params = params
        self.validation = validation
        self.raw = raw  # skip host augmentation (device-augment mode)
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self.threads = []
        for i in range(max(1, num_threads)):
            rng = np.random.RandomState(seed + i)
            t = threading.Thread(target=self._worker, args=(rng,),
                                 daemon=True)
            t.start()
            self.threads.append(t)

    def _worker(self, rng):
        while not self._stop.is_set():
            batch = self.sampler.generate_train_batch()
            if self.raw:
                out = {"data": batch["data"], "seg": batch["seg"]}
            else:
                out = augment_batch(batch, self.params, rng,
                                    validation=self.validation)
            while not self._stop.is_set():
                try:
                    self.queue.put(out, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __next__(self):
        return self.queue.get()

    def next(self):
        return self.__next__()

    def stop(self):
        self._stop.set()
        # drain so workers blocked on put() can exit
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
