"""Detection operations: box and mask ops, the COCO matcher and the RLE codec."""
from metrics_tpu_torch.ops.detection import matching, rle
from metrics_tpu_torch.ops.detection.boxes import box_area, box_convert, box_iou, mask_area, mask_iou
from metrics_tpu_torch.ops.detection.matching import match_image

__all__ = ["box_area", "box_convert", "box_iou", "mask_area", "mask_iou", "match_image"]
