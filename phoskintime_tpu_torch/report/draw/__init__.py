"""The port's drawing layer: figures as PNG, PDF and animated GIF files
with numpy and the standard library alone (no matplotlib, no pillow).

:mod:`figure` holds the scene (the part of matplotlib's API the figure
writers use, and :meth:`Figure.record`, what a figure draws as data);
:mod:`display` the primitives it draws; :mod:`raster` and :mod:`png` the
pixels, :mod:`pdf` the vector pages, :mod:`gif` the animations;
:mod:`font` the stroke font; :mod:`colors` the colours and colormaps;
:mod:`scale` the axis scales and ticks.
"""

from phoskintime_tpu_torch.report.draw.colors import (  # noqa: F401
    TAB10,
    TAB20,
    cmap_color,
    colormap,
    lighten,
    to_hex,
    to_rgba,
)
from phoskintime_tpu_torch.report.draw.figure import (  # noqa: F401
    Axes,
    Axes3D,
    Circle,
    FancyBboxPatch,
    Figure,
    FuncAnimation,
    Path,
    PathPatch,
    PdfPages,
    subplots,
)
