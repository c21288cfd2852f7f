"""Pricing-method lifecycle (NMCH base class, NMCH_FE)."""
