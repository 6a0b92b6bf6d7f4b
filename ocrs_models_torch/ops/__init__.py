from .gru import BiGRU, gru_recurrence, gru_recurrence_reference
from .stage1 import stage1, stage1_reference

__all__ = ["BiGRU", "gru_recurrence", "gru_recurrence_reference", "stage1", "stage1_reference"]
