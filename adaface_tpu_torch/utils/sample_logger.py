"""Asynchronous training-sample logger.

Counterpart of `adaface_tpu/utils/sample_logger.py` (the reference's
`cache_and_log_generations`, `ddpm.py:3775-3853`): samples are pushed onto a
bounded queue, and a worker thread writes each batch as a grid with a border
coloured by iteration type, so that the train loop never waits on the disk.
The grids are PNGs written by `utils.image.write_png` (no PIL needed).
`log_latents` hands the worker latents and the function that decodes them
(the trainer's previews, `trainer.py:622-634`): the worker decodes them too,
on a CUDA stream of its own for a CUDA tensor, after the work that made
them, so the train loop waits for neither the decode nor the disk.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

ITER_TYPE_COLORS = {
    "recon": (64, 160, 64),  # green
    "unet_distill": (64, 64, 200),  # blue
    "comp_distill": (200, 64, 64),  # red
    "sample": (128, 128, 128),
}


def _to_grid(images: np.ndarray, cols: int = 4, border: int = 4,
             color=(128, 128, 128)) -> np.ndarray:
    """[N, 3, H, W] floats in [0, 1] → a bordered grid, uint8 [rows·(H+2b),
    cols·(W+2b), 3]."""
    arr = (np.clip(images, 0, 1) * 255).astype(np.uint8).transpose(0, 2, 3, 1)
    n, h, w, _ = arr.shape
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    bh, bw = h + 2 * border, w + 2 * border
    grid = np.empty((rows * bh, cols * bw, 3), np.uint8)
    grid[...] = color
    for i, im in enumerate(arr):
        r, c = divmod(i, cols)
        grid[r * bh + border:r * bh + border + h, c * bw + border:c * bw + border + w] = im
    return grid


class SampleLogger:
    def __init__(self, log_dir: str, max_queue: int = 120):
        self.dir = os.path.join(log_dir, "samples")
        os.makedirs(self.dir, exist_ok=True)
        self.q: queue.Queue = queue.Queue(maxsize=max_queue)
        self.dropped = 0
        self._stream = None  # the worker's CUDA stream for decodes
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def log(self, step: int, iter_type: str, images) -> bool:
        """Enqueue without blocking; a full queue drops the batch (the train
        loop never stalls on the disk). → False if dropped."""
        if isinstance(images, torch.Tensor):
            images = images.detach().float().cpu().numpy()
        return self._put((step, iter_type, np.asarray(images), None, None))

    def log_latents(self, step: int, iter_type: str, latents: torch.Tensor, decode) -> bool:
        """Enqueue without blocking latents that the worker decodes with
        `decode` (→ [N, 3, H, W] in [-1, 1]) and writes as `log` writes
        images in [0, 1]. → False if dropped."""
        event = None
        if latents.is_cuda:
            event = torch.cuda.Event()
            event.record()  # on the producer's stream
        return self._put((step, iter_type, latents.detach(), decode, event))

    def _put(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except queue.Full:
            self.dropped += 1
            return False

    @torch.no_grad()
    def _decode(self, latents: torch.Tensor, decode, event) -> np.ndarray:
        if event is None:
            images = decode(latents)
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(latents.device)
            self._stream.wait_event(event)
            with torch.cuda.stream(self._stream):
                latents.record_stream(self._stream)
                images = decode(latents).float().cpu()
        return (images.float().numpy() + 1) / 2

    def _run(self):
        from adaface_tpu_torch.utils.image import write_png

        while True:
            item = self.q.get()
            if item is None:
                return
            step, iter_type, images, decode, event = item
            try:
                if decode is not None:
                    images = self._decode(images, decode, event)
                grid = _to_grid(images, color=ITER_TYPE_COLORS.get(iter_type, (128, 128, 128)))
                write_png(os.path.join(self.dir, f"{step:07d}_{iter_type}.png"), grid)
            except Exception as e:  # never kill the worker
                print(f"sample logger error at step {step}: {e}")
            finally:
                self.q.task_done()

    def close(self, timeout: float = 10.0):
        """Wait for the queued grids, then stop the worker."""
        self.q.join()
        self.q.put(None)
        self._worker.join(timeout)
