from .state import MapState, KeyframeDB, init_state  # noqa: F401
from .tracker import TrackConfig, track_frame  # noqa: F401
from .mapper import MapOptConfig, optimize_map  # noqa: F401
from .system import NiceSLAM  # noqa: F401
