"""1-D adaptive-grid quality controls (the reference's Grid mixin).

The port's copy of the JAX package's ``models/grid.py``: the mesh-keyword
surface shared by every 1-D steady flame model: initial and maximum point
counts (NPTS/NTOT), domain bounds (XSTR/XEND), reaction zone estimate
(XCEN/WMIX), adaption budget (NADP) and the GRAD/CURV solution-quality
ratios consumed by :func:`pychemkin_tpu_torch.ops.flame1d.refine_grid`.
"""

from __future__ import annotations

import numpy as np

from ..logger import logger


class Grid:
    """Grid quality control parameters for 1-D steady-state models
    (reference grid.py:38-60 defaults)."""

    def __init__(self):
        self.max_numb_grid_points = 250       # NTOT
        self.max_numb_adapt_points = 10       # NADP
        self.gradient = 0.1                   # GRAD
        self.curvature = 0.5                  # CURV
        self.numb_grid_points = 6             # NPTS
        self.starting_x = 0.0                 # XSTR
        self.ending_x = 0.0                   # XEND
        self.reaction_zone_center_x = 0.0     # XCEN
        self.reaction_zone_width = 0.0        # WMIX
        self.grid_profile: list = []          # explicit GRID x values
        self.numb_grid_profile = 0

    def set_numb_grid_points(self, numb_points: int):
        """Initial uniform grid points (reference grid.py:54)."""
        if numb_points > 0:
            self.numb_grid_points = int(numb_points)
        else:
            logger.error("number of points must > 0.")

    def set_max_grid_points(self, numb_points: int):
        """Cap on points during refinement (reference grid.py:70)."""
        if numb_points > 0:
            self.max_numb_grid_points = int(numb_points)
        else:
            logger.error("number of points must > 0.")

    @property
    def start_position(self) -> float:
        """Coordinate of the first grid point [cm] (reference
        grid.py:87)."""
        return self.starting_x

    @start_position.setter
    def start_position(self, position: float):
        self.starting_x = float(position)

    @property
    def end_position(self) -> float:
        """Coordinate of the last grid point [cm] (reference
        grid.py:111)."""
        return self.ending_x

    @end_position.setter
    def end_position(self, position: float):
        self.ending_x = float(position)

    def set_reaction_zone_center(self, position: float):
        """XCEN — estimated flame-front location (reference
        grid.py:139)."""
        self.reaction_zone_center_x = float(position)

    def set_reaction_zone_width(self, size: float):
        """WMIX — estimated mixing-zone width (reference grid.py:159)."""
        self.reaction_zone_width = float(size)

    def set_max_adaptive_points(self, numb_points: int):
        """NADP — points added per adaption pass (reference
        grid.py:175)."""
        if numb_points > 0:
            self.max_numb_adapt_points = int(numb_points)
        else:
            logger.error("number of points must > 0.")

    def set_solution_quality(self, gradient: float = 0.1,
                             curvature: float = 0.5):
        """GRAD/CURV adaption ratios (reference grid.py:201): an interval
        is refined when a component's jump exceeds ``gradient`` times its
        range or its slope jump exceeds ``curvature`` times the slope
        range."""
        if not 0.0 < gradient <= 1.0 or not 0.0 < curvature <= 1.0:
            logger.error("GRAD/CURV must be in (0, 1].")
            return
        self.gradient = float(gradient)
        self.curvature = float(curvature)

    def set_grid_profile(self, mesh) -> int:
        """Explicit initial mesh (reference grid.py:239 ``GRID x``
        profile). Overrides NPTS when set."""
        mesh = np.asarray(mesh, dtype=np.float64)
        if mesh.ndim != 1 or mesh.size < 2:
            logger.error("grid profile needs >= 2 points")
            return 1
        if not np.all(np.diff(mesh) > 0):
            logger.error("grid profile must be strictly increasing")
            return 1
        self.grid_profile = list(map(float, mesh))
        self.numb_grid_profile = mesh.size
        self.starting_x = float(mesh[0])
        self.ending_x = float(mesh[-1])
        return 0
