"""Optimisers of the port: ``gradcomp`` (WORp gradient compression with
error feedback, over a ``torch.distributed`` process group) and ``adamw``
(the AdamW step that applies it)."""
