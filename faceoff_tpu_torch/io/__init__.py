"""Files: weight bridges into the port, images, sample videos and
checkpoints."""
