"""Write the mp4 fixture of the port's MPEG-4 Part 2 decoder and cv2's
decode of it.

    python tools/make_mp4_fixture.py

Writes under tests/data_torch/: face_mp4v.mp4, 24 frames of a drifting
synthetic face (faceoff_tpu_torch.data.synthetic, seed 4) at 104 x 104
(no multiple of 16, so the decoders' edge handling shows; 24 frames, so
two GOPs of cv2's writer), written by `faceoff_tpu.io.video.
save_frames_as_video` (cv2, `mp4v`); and face_mp4v.npz, cv2's RGB decode
of that file (`frames`, (24, 104, 104, 3) uint8) beside the frames that
were written (`source`). `chip_smoke.py` and the CPU tests decode the
file with the port and compare with the stored decode. Needs cv2 and the
JAX package's environment, so it runs off the card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from faceoff_tpu.io.video import (read_video_frames,  # noqa: E402
                                  save_frames_as_video)
from faceoff_tpu_torch.data.synthetic import video_frames  # noqa: E402

OUT = REPO / "tests" / "data_torch"
N_FRAMES, SIZE, SEED = 24, 104, 4


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    frames = video_frames(N_FRAMES, SIZE, seed=SEED)[0].numpy()
    path = OUT / "face_mp4v.mp4"
    save_frames_as_video(list(frames), str(path))
    decoded = np.stack(read_video_frames(str(path)))
    np.savez_compressed(OUT / "face_mp4v.npz", frames=decoded, source=frames)
    print(path.relative_to(REPO), path.stat().st_size, "bytes,",
          decoded.shape[0], "frames")


if __name__ == "__main__":
    main()
