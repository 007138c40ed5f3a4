"""The FC2 metrics: FID on InceptionV3 pool3 features and LPIPS on AlexNet's
(port of ``vst/metrics``)."""
