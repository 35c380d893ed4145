"""Core: distribution tags, the environment, the grid and DistMatrix."""

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
from .grid import Grid  # noqa: F401
from .dmatrix import DistMatrix, check_same_grid  # noqa: F401
