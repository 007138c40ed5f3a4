"""Training: the feed-forward family (``faststyle``, ``registry``,
``experiments``) and the StarGAN family (``stargan``, ``stargan2``, with the
compute-dtype ``policy``); ``parity`` holds a step against another device."""
