"""The agent's wire format (`agent.wire`): the EV_* record types and the
JSON-header message framing the capture journal and history store write.
The agent daemon and its gRPC service wait for their ROADMAP item."""
