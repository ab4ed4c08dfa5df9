"""Write the JPEG fixtures of the port's nvJPEG check and their cv2
decodes.

    python tools/make_jpeg_fixture.py

Writes under tests/data_torch/: face_420.jpg and face_444.jpg, one
104 x 104 synthetic face frame (faceoff_tpu_torch.data.synthetic, seed 4;
104 is no multiple of the 16-pixel 4:2:0 block, so the decoders' edge
handling shows) encoded by cv2 at quality 90 with 4:2:0 and with 4:4:4
chroma sampling, and face_420.npy / face_444.npy, cv2's RGB decodes of
those files; and face256_0.jpg .. face256_5.jpg, six 256 x 256 frames of
six synthetic videos (seeds 10-15, so that any two differ everywhere),
quality 90, 4:2:0 and 4:4:4 in turn.
`chip_smoke.py` decodes the JPEGs with nvJPEG on the card and compares
the small ones with the .npy files; it stages a corpus of copies of the
256-pixel ones and holds every staged frame against its own decode.
Needs cv2, so it runs where the JAX package's environment is, not on the
card's machine.
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from faceoff_tpu_torch.data.synthetic import video_frames  # noqa: E402

OUT = REPO / "tests" / "data_torch"
N_FRAMES_256 = 6
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    frames, _ = video_frames(1, 128, seed=4)
    rgb = np.ascontiguousarray(frames[0].numpy()[12:116, 12:116])
    for name, factor in SAMPLING.items():
        path = OUT / f"face_{name}.jpg"
        ok = cv2.imwrite(str(path), rgb[..., ::-1],
                         [cv2.IMWRITE_JPEG_QUALITY, 90,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
        if not ok:
            raise RuntimeError(f"cv2 could not write {path}")
        decoded = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
        np.save(OUT / f"face_{name}.npy", np.ascontiguousarray(decoded))
        print(path.relative_to(REPO), path.stat().st_size, "bytes")
    for i in range(N_FRAMES_256):
        frame = video_frames(1, 256, seed=10 + i)[0][0].numpy()
        factor = list(SAMPLING.values())[i % 2]
        path = OUT / f"face256_{i}.jpg"
        if not cv2.imwrite(str(path), frame[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 90,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]):
            raise RuntimeError(f"cv2 could not write {path}")
        print(path.relative_to(REPO), path.stat().st_size, "bytes")


if __name__ == "__main__":
    main()
