"""Data layer: OSCD scanning, PNG decoding, the decode-once cache."""
