from .faults import RoundOutcome, apply_faults, quorum_met, resolve_outcome
from .rounds import FedAvgConfig, FedAvgResult, run_fedavg
from .scenarios import (ChurnConfig, DealerConfig, ScenarioConfig,
                        StragglerConfig, run_scenario)
from .simulation import FLSimulation, UnknownPartyError
from .transport import (Network, P2PTransport, PhaseStats, PlainTransport,
                        SPMDTransport, Transport, TwoPhaseTransport,
                        make_transport)

__all__ = ["FLSimulation", "Network", "PhaseStats", "FedAvgConfig",
           "FedAvgResult", "run_fedavg", "RoundOutcome", "apply_faults",
           "quorum_met", "resolve_outcome", "Transport", "P2PTransport",
           "TwoPhaseTransport", "PlainTransport", "SPMDTransport",
           "make_transport", "ChurnConfig", "DealerConfig",
           "ScenarioConfig", "StragglerConfig", "run_scenario",
           "UnknownPartyError"]
