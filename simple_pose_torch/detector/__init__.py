"""The YOLOv5/YOLOv4 person detector: blocks, models, NMS and the
letterbox front end (port of simple_pose_tpu/detector)."""
