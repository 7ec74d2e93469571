"""CLI tools: cli (llama-cli analog) and the argument registry."""
