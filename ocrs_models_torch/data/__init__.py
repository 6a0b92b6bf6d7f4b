from .collate import collate_layout, collate_recognition
from .loader import DataLoader
from .synthetic import SyntheticLayout, SyntheticRecognition

__all__ = [
    "DataLoader",
    "SyntheticLayout",
    "SyntheticRecognition",
    "collate_layout",
    "collate_recognition",
]
