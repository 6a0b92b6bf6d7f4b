from .collate import collate_recognition
from .loader import DataLoader
from .synthetic import SyntheticRecognition

__all__ = ["DataLoader", "SyntheticRecognition", "collate_recognition"]
