"""Utilities: the GAN sample strip, run control (the SIGTERM guard, the
JSONL run log, step timing, traces and finite checks) and the reader of
flax's ``.msgpack`` checkpoints."""
