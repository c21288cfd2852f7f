"""Counter-based Philox streams and normal variates on int64 tensors."""
