from .synthetic import fault_detection_party, train_test_split

__all__ = ["fault_detection_party", "train_test_split"]
