from .partition import PartyLoader, dirichlet_partition
from .synthetic import fault_detection_party, lm_batch, train_test_split

__all__ = ["PartyLoader", "dirichlet_partition", "fault_detection_party",
           "lm_batch", "train_test_split"]
