"""Data of the PyTorch port: image preparation and minibatches, the roidb,
the VOC and COCO datasets and their evaluators."""
