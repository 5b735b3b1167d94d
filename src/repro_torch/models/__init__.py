"""The model stack of the port: ``config`` (ArchConfig), ``layers``
(attention, MLP, Mamba and Hymba blocks as ``nn.Module``s), ``model``
(``Model``, ``init_params``, ``forward``, ``decode_step``) and ``weights``
(carrying the reference package's parameters over)."""
