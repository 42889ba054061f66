"""Serving: the page table, paged KV and the decode engine."""
