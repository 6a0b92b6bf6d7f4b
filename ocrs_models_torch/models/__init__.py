from .detection import DetectionModel
from .layout import LayoutModel
from .recognition import RecognitionModel

__all__ = ["DetectionModel", "LayoutModel", "RecognitionModel"]
