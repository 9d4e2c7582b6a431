"""Wire codecs, merge trees and the in-process fleet plane of the port.

``codecs`` (the wire images, byte for byte the reference's), ``sharding``
(the merge trees: host forms and the ``torch.distributed`` collective
form) and ``fleet`` (the ``fleet`` data plane, registered by
``repro_torch.engine.planes``).  ``pytree`` walks the port's state trees in
the reference's leaf order."""
