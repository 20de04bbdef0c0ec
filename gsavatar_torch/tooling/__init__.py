"""Host-side tooling: CLIFF-input preprocessing, skeleton overlays, and the
custom-dataset build pipeline.

Counterpart of `gsavatar/tooling/`. The JAX package's tooling calls OpenCV
for its drawing, resizing, contours and file I/O; the port's calls its own
code, held pixel-equal to OpenCV (`utils/draw.py`, `utils/contours.py`,
`data/image_ops.py`, `native`'s JPEG codec, `utils/png.py`). Only video
reads and writes go through OpenCV, in `motion/streams.py`."""
from . import build_dataset, cliff, skeleton  # noqa: F401
