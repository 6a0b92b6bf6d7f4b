from .collate import collate_detection, collate_layout, collate_recognition
from .loader import DataLoader
from .synthetic import SyntheticDetection, SyntheticLayout, SyntheticRecognition

__all__ = [
    "DataLoader",
    "SyntheticDetection",
    "SyntheticLayout",
    "SyntheticRecognition",
    "collate_detection",
    "collate_layout",
    "collate_recognition",
]
