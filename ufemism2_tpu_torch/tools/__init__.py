"""Host tools of the port: input data writers and post-processing (the
L10 layer): run inspection, diagnostics and plotting of model output.

Re-design of tools/python/upsy/ (Run/Mesh/Timeframe classes + the
upsy-diagnose-run / upsy-plot-2dfigure CLIs). matplotlib is imported only
by the functions that plot or contour."""

from .run import Run
