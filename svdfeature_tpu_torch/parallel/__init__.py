"""Multi-device training: one process per (data, model) mesh position."""
