"""Float models of the port: slim_yolo_v2, darknet53 and yolo_v3 as
``nn.Module``s, in the BN form and the BN-fused form."""
