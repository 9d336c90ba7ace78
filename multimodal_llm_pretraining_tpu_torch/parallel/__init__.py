"""Device topology (one host, one GPU so far)."""
