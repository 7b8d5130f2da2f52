"""Synthetic registration data: smooth random volumes and known warps.

The port's own copy of pulpo_tpu/data/synthetic.py:15-97 (numpy only),
so that the same seed gives the same volumes in both packages. It
supplies the inputs of `chip_smoke.py` and of the tests.
"""

from __future__ import annotations

import numpy as np


def random_smooth_volume(rng: np.random.Generator, shape, smoothness: float = 0.15):
    """Band-limited random volume in [0, 1] via low-frequency FFT noise."""
    noise = rng.standard_normal(shape).astype(np.float32)
    f = np.fft.fftn(noise)
    filt = np.ones(shape, dtype=np.float32)
    for ax, s in enumerate(shape):
        freq = np.abs(np.fft.fftfreq(s))
        # keep at least the first harmonic so tiny volumes aren't constant
        cutoff = max(smoothness * 0.5, 1.01 / s)
        keep = (freq <= cutoff).astype(np.float32)
        filt *= keep.reshape([-1 if i == ax else 1 for i in range(len(shape))])
    img = np.real(np.fft.ifftn(f * filt)).astype(np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-8)


def random_smooth_svf(rng: np.random.Generator, shape, magnitude: float = 3.0):
    """Smooth random stationary velocity field (*shape, ndims)."""
    nd = len(shape)
    comps = [
        (random_smooth_volume(rng, shape, smoothness=0.1) - 0.5) * 2 * magnitude
        for _ in range(nd)
    ]
    return np.stack(comps, axis=-1).astype(np.float32)


def blobby_segmentation(img: np.ndarray, num_classes: int = 4):
    """Quantize intensities into `num_classes` labels (incl. background)."""
    edges = np.quantile(img, np.linspace(0, 1, num_classes + 1)[1:-1])
    return np.digitize(img, edges).astype(np.int64)


class SyntheticDataset:
    """In-memory dataset with the 8-tuple pair schema."""

    def __init__(
        self,
        shape=(32, 32, 32),
        n: int = 8,
        segs: bool = False,
        lms: bool = False,
        num_classes: int = 4,
        num_landmarks: int = 5,
        seed: int = 0,
    ):
        self.shape = tuple(shape)
        self.segs = segs
        self.lms = lms
        self.num_classes = num_classes
        rng = np.random.default_rng(seed)
        self.images = [random_smooth_volume(rng, self.shape) for _ in range(n)]
        self.seg_labels = [blobby_segmentation(im, num_classes) for im in self.images]
        self.landmarks = [
            np.stack([rng.integers(2, s - 2, num_landmarks) for s in self.shape], -1)
            .astype(np.float32)
            for _ in range(n)
        ]

    def __len__(self):
        return len(self.images)

    def _onehot(self, labels):
        eye = np.eye(self.num_classes, dtype=np.float32)
        return eye[labels]  # (*shape, num_classes)

    def get_pair(self, index: int, rng: np.random.Generator):
        # random partner != index
        j = index
        while j == index:
            j = int(rng.integers(0, len(self)))
        item = {
            "x": self.images[index][..., None],
            "y": self.images[j][..., None],
            "seg_x": self._onehot(self.seg_labels[index]) if self.segs else None,
            "seg_y": self._onehot(self.seg_labels[j]) if self.segs else None,
            "lm_x": self.landmarks[index] if self.lms else None,
            "lm_y": self.landmarks[j] if self.lms else None,
            "mask_x": None,
            "mask_y": None,
        }
        return item
