"""Serving runtime: allocator, scheduler, sampler, engines."""
