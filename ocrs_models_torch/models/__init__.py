from .detection import DetectionModel
from .recognition import RecognitionModel

__all__ = ["DetectionModel", "RecognitionModel"]
