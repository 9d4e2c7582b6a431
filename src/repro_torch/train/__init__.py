"""Training-side state handling of the port: ``checkpoint`` (atomic,
CRC-verified, codec-aware; the reference's file format)."""
