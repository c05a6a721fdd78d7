"""The port's launchers (``repro.launch``'s entry points): ``train``,
the training launcher of every trainable architecture of the registry,
and ``serve``, the paper's workload as a service.  Both run on the card
(``--device cuda``, the default) unless the caller asks for the CPU."""
