"""Float models of the port: slim_yolo_v2, tiny_yolo_v3 (darknet_light),
yolo_v2 (darknet19), yolo_v3 and yolo_v3_spp (darknet53) as
``nn.Module``s, in the BN form and the BN-fused form."""
