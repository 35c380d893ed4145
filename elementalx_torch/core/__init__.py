"""Core: distribution tags, the environment, the grid, DistMatrix, the
collectives between grid positions and the redistributions."""

from .types import *  # noqa: F401,F403
from .environment import (  # noqa: F401
    Blocksize,
    ElError,
    LogicError,
    NonHPDMatrixException,
    PopBlocksizeStack,
    PushBlocksizeStack,
    SetBlocksize,
    blocksize,
)
from .grid import DefaultGrid, Grid, default_grid_height  # noqa: F401
from .dmatrix import DistMatrix, check_same_grid  # noqa: F401
from . import collectives  # noqa: F401
from . import redistribute  # noqa: F401
from .redistribute import (  # noqa: F401
    AllGather,
    ColAllGather,
    ColAllToAllDemote,
    ColAllToAllPromote,
    ColFilter,
    Copy,
    Exchange,
    Filter,
    Gather,
    PartialColAllGather,
    PartialColFilter,
    PartialRowAllGather,
    RowAllGather,
    RowFilter,
    Scatter,
    TransposeDist,
    Translate,
    TranslateBetweenGrids,
)
