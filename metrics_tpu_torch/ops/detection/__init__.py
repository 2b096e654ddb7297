from metrics_tpu_torch.ops.detection.boxes import box_area, box_convert, box_iou

__all__ = ["box_area", "box_convert", "box_iou"]
