from .synthetic import fault_detection_party, lm_batch, train_test_split

__all__ = ["fault_detection_party", "lm_batch", "train_test_split"]
