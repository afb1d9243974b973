from .sql import SqlError, parse as parse_sql
from .engine import Rule, RuleEngine
from .events import EVENT_TOPICS, client_event, message_event
