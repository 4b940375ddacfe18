"""Operator tools over the port: the metrics scrape endpoint
(`moscrape`) and the tracing smoke gate (`motrace`)."""
