"""Numpy COCO keypoint evaluation and the training heatmap accuracy."""
