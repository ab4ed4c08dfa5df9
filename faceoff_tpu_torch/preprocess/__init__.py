"""Offline preprocessing, counterpart of `faceoff_tpu/preprocess`: raw
videos to face-crop clips (`face_crop`), clips to frames and landmarks in
the dataset contract (`landmarks`), with the detector and landmarkers of
`detectors` and the image operations of `imgproc`."""
