"""Online serving: streaming (frame-at-a-time) swap inference and
serving bundles exported with `torch.export`."""

from faceoff_tpu_torch.serve.export import (
    export_offline,
    export_streaming,
    load_bundle,
    save_bundle,
)
from faceoff_tpu_torch.serve.streaming import (
    StreamingSwapper,
    SwapSession,
    make_stream_steps,
    stream_video,
)

__all__ = [
    "StreamingSwapper",
    "SwapSession",
    "export_offline",
    "export_streaming",
    "load_bundle",
    "make_stream_steps",
    "save_bundle",
    "stream_video",
]
