#include "logging.h"

#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <mutex>

#include "common.h"

namespace hvdtorch {

namespace {
LogLevel g_min_level = LogLevel::kWarning;
bool g_timestamps = false;
std::once_flag g_env_once;
std::mutex g_write_mutex;

void InitFromEnv() {
  const char* lvl = std::getenv("HOROVOD_LOG_LEVEL");
  if (lvl != nullptr) g_min_level = ParseLogLevel(lvl);
  const char* ts = std::getenv("HOROVOD_LOG_TIMESTAMP");
  g_timestamps = (ts != nullptr && ts[0] != '0');
}

const char* LevelName(LogLevel l) {
  switch (l) {
    case LogLevel::kTrace: return "TRACE";
    case LogLevel::kDebug: return "DEBUG";
    case LogLevel::kInfo: return "INFO";
    case LogLevel::kWarning: return "WARNING";
    case LogLevel::kError: return "ERROR";
    case LogLevel::kFatal: return "FATAL";
  }
  return "?";
}
}  // namespace

LogLevel MinLogLevel() {
  std::call_once(g_env_once, InitFromEnv);
  return g_min_level;
}

void SetMinLogLevel(LogLevel lvl) {
  std::call_once(g_env_once, InitFromEnv);
  g_min_level = lvl;
}

LogLevel ParseLogLevel(const std::string& s) {
  if (s == "trace" || s == "0") return LogLevel::kTrace;
  if (s == "debug" || s == "1") return LogLevel::kDebug;
  if (s == "info" || s == "2") return LogLevel::kInfo;
  if (s == "warning" || s == "3") return LogLevel::kWarning;
  if (s == "error" || s == "4") return LogLevel::kError;
  if (s == "fatal" || s == "5") return LogLevel::kFatal;
  return LogLevel::kWarning;
}

LogMessage::LogMessage(const char* file, int line, LogLevel level)
    : level_(level) {
  const char* base = file;
  for (const char* p = file; *p; ++p) {
    if (*p == '/') base = p + 1;
  }
  stream_ << "[hvdtorch " << LevelName(level) << " " << base << ":" << line << "] ";
  if (g_timestamps) {
    char buf[32];
    std::time_t t = std::time(nullptr);
    std::strftime(buf, sizeof(buf), "%H:%M:%S", std::localtime(&t));
    stream_ << buf << " ";
  }
}

LogMessage::~LogMessage() {
  std::lock_guard<std::mutex> lock(g_write_mutex);
  std::fprintf(stderr, "%s\n", stream_.str().c_str());
  std::fflush(stderr);
  if (level_ == LogLevel::kFatal) std::abort();
}

}  // namespace hvdtorch
