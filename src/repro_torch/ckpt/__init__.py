"""REFT-Ckpt retention: the persisted-family manager."""
