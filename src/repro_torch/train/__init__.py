"""Train-step factory and the train state."""
