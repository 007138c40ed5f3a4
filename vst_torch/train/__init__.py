"""Training: the feed-forward family (``faststyle``, ``registry``,
``experiments``), the StarGAN family (``stargan``, ``stargan2``, with the
compute-dtype ``policy``) and RAFT at its chairs stage (``raft``); ``parity``
holds a step against another device."""
