"""Rules, the rule-gated pipeline and its dispatch plans."""
