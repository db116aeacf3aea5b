"""Real multi-process wire transport for the two-phase MPC protocol.

Counterpart of ``repro/net/``: length-prefixed versioned frames
(``wire``), array/pytree codecs (``codec``), chunk reassembly and Eqs.
1-8 wire accounting (``messages``), injectable-clock dropout detection
(``timeouts``), registration leases (``registry``), the tree relay's
home-member ingest (``region``), the asyncio coordinator on the host and
the party workers, whose share math runs on their own device
(``coordinator`` / ``party``), and the ``Transport``-conforming facade
(``transport.WireTransport``).  See DESIGN.md §9 and §13.
"""

from .config import WireConfig
from .coordinator import RelayDropped
from .messages import MessageAssembler, MessageMeter
from .region import RegionIngest
from .registry import PartyLease, PartyRegistry
from .timeouts import ManualClock, StageMonitor, SystemClock
from .transport import WireTransport
from .wire import (BadMagicError, Frame, FrameReader, MsgType,
                   OversizedFrameError, PartyFailedError, Phase,
                   ProtocolError, Scheme, StaleSessionError,
                   TruncatedFrameError, VersionError, WireError,
                   WireTimeoutError, Wiredtype)

__all__ = [
    "BadMagicError", "Frame", "FrameReader", "ManualClock",
    "MessageAssembler", "MessageMeter", "MsgType", "OversizedFrameError",
    "PartyFailedError", "PartyLease", "PartyRegistry", "Phase",
    "ProtocolError", "RegionIngest", "RelayDropped", "Scheme",
    "StageMonitor", "StaleSessionError", "SystemClock",
    "TruncatedFrameError", "VersionError", "WireConfig", "WireError",
    "WireTimeoutError", "WireTransport", "Wiredtype",
]
