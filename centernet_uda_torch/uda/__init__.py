"""Trainers. Only the no-UDA baseline ``Model`` is ported so far (ROADMAP A8
holds the UDA strategies)."""
