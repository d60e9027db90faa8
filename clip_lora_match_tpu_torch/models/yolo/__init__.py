from clip_lora_match_tpu_torch.models.yolo.cropper import YoloCropper, load_yolo_cropper
from clip_lora_match_tpu_torch.models.yolo.postprocess import decode_boxes, nms_fixed

__all__ = ["YoloCropper", "load_yolo_cropper", "nms_fixed", "decode_boxes"]
